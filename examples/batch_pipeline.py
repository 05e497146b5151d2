"""Batch-process a manifest of clips through the full chain.

Builds a few synthetic clips, writes a manifest, and runs the bucketed
ragged batch runner (decode thread -> SPSC ring -> device dispatch ->
writer thread) with resume markers and per-clip failure isolation:

    python examples/batch_pipeline.py /tmp/xmtpu_demo
"""

import json
import os
import sys

import numpy as np

from xmtpu.io import write_wav
from xmtpu.runner import run_batch


def main(outdir: str = "/tmp/xmtpu_demo") -> None:
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(7)
    jobs = []
    for i, seconds in enumerate((3.0, 5.0, 2.2)):
        n = int(44100 * seconds)
        t = np.arange(n) / 44100.0
        tone = np.sin(2 * np.pi * (220 * (i + 1)) * t)
        voice = ((tone + 0.05 * rng.standard_normal(n)) * 12000).astype(
            np.int16)
        src = os.path.join(outdir, f"voice_{i}.wav")
        write_wav(src, voice, 44100)
        jobs.append({"voice": src,
                     "out": os.path.join(outdir, f"out_{i}.wav")})
    # write + reload a manifest file — the exact flow of
    # `python -m xmtpu.cli batch manifest.json`
    mpath = os.path.join(outdir, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(jobs, f, indent=1)
    with open(mpath) as f:
        manifest = json.load(f)
    rep = run_batch(manifest, sr_in=44100, sr_bus=16000, batch_size=4,
                    pipeline=True)
    print(rep.to_json())


if __name__ == "__main__":
    main(*sys.argv[1:])
