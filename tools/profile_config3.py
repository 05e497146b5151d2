"""Trace the config-3 chain (stereo 48k EQ+reverb+limiter through the
public xmtpu.effects) on the card with the JAX profiler.

Usage: python tools/profile_config3.py [TRACE_DIR]
(default ``chiprun_out/trace_config3``). One warm-up call, then 3
traced steady-state calls, each ended by ``block_until_ready``.
"""
import glob
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np
import jax
import jax.numpy as jnp

from xmtpu import effects
from xmtpu.batch import DEFAULT_BANDS
from xmtpu.ops import reverb

out_dir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
    ROOT, "chiprun_out", "trace_config3")
sr, seconds, batch = 48000, 10.0, 16
n = int(sr * seconds)
rng = np.random.default_rng(0)
x = jnp.asarray((0.3 * rng.standard_normal((batch, n, 2))).astype(np.float32))
ir = reverb.synthetic_ir(0.5, sr).astype(np.float32)
chain = [
    {"name": "equalizer", "params": {"bands": list(DEFAULT_BANDS)}},
    {"name": "reverb", "params": {"ir": ir, "wet": 0.3, "dry": 0.7}},
    {"name": "limiter", "params": {}},
]
effects(x, sr, chain, device_out=True).block_until_ready()
jax.profiler.start_trace(out_dir)
for _ in range(3):
    out = effects(x, sr, chain, device_out=True)
out.block_until_ready()
jax.profiler.stop_trace()
print("trace files:", [p for p in glob.glob(f"{out_dir}/**/*", recursive=True)
                       if os.path.isfile(p)][:10])
