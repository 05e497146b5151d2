"""Trace the headline flagship step (config 4) on the card with the JAX
profiler.

Usage: python tools/profile_headline.py [TRACE_DIR]
(default ``chiprun_out/trace_headline``). One warm-up step, then 3
traced steady-state steps, each ended by ``block_until_ready``.
"""
import glob
import os
import sys

# running as `python tools/profile_headline.py` puts tools/ (not the
# repo root) at sys.path[0]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np
import jax
import jax.numpy as jnp

from xmtpu import batch as xbatch

out_dir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
    ROOT, "chiprun_out", "trace_headline")
sr_in, n, batch = 44100, 441000, 256
rng = np.random.default_rng(0)
voice = jnp.asarray((rng.standard_normal((batch, n)) * 9000).astype(np.int16))
bgm = jnp.asarray((np.sin(np.arange(n) / 50.0)[None].repeat(batch, 0)
                   * 12000).astype(np.int16))
step = jax.jit(xbatch.make_flagship_step())
step(voice, bgm).block_until_ready()
jax.profiler.start_trace(out_dir)
for _ in range(3):
    out = step(voice, bgm)
out.block_until_ready()
jax.profiler.stop_trace()
print("trace files:", [p for p in glob.glob(f"{out_dir}/**/*", recursive=True)
                       if os.path.isfile(p)][:10])
