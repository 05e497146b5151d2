"""Benchmark harness (repo-root contract).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"accuracy_db", "device"}.

Metric: audio-seconds processed per wall-second per device through the
full chain — int16 in, 44.1k->16k polyphase resample, voice+BGM mix
with gain/fades, peak normalize, 5-band biquad EQ, FIR reverb,
soft-knee limiter, int16 out (BASELINE.json:2,5). ``vs_baseline`` is
the ratio to the >=500x-realtime target of BASELINE.json:5.
``accuracy_db`` is clip 0 of the last batch against the float64 oracle
(gate: -80 dB). Each timed step ends in ``block_until_ready``.

Run: ``python bench.py [batch=256] [clip_seconds=10] [iters=20]``.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

TARGET_RT = 500.0  # x realtime per device (BASELINE.json:5)


def main(batch: int = 256, clip_seconds: float = 10.0, iters: int = 20) -> dict:
    import jax
    from xmtpu import batch as xbatch

    sr_in = 44100
    n = int(sr_in * clip_seconds)
    rng = np.random.default_rng(0)
    voice = (rng.standard_normal((batch, n)) * 9000).astype(np.int16)
    bgm = (np.sin(np.arange(n) / 50.0)[None].repeat(batch, 0) * 12000).astype(
        np.int16
    )

    step = jax.jit(xbatch.make_flagship_step(sr_in=sr_in, sr_bus=16000))
    v_dev = jax.device_put(voice)
    b_dev = jax.device_put(bgm)
    out = step(v_dev, b_dev).block_until_ready()  # compile + warm-up

    t0 = time.perf_counter()
    for _ in range(iters):
        out = step(v_dev, b_dev)
    out.block_until_ready()
    dt = time.perf_counter() - t0
    value = batch * clip_seconds * iters / dt

    y0 = np.asarray(out[0]).astype(np.float64)
    ref = xbatch.flagship_oracle_np(voice[0], bgm[0]).astype(np.float64)
    p_err = float(np.mean((y0 - ref) ** 2))
    acc_db = (-np.inf if p_err == 0
              else 10.0 * np.log10(p_err / max(float(np.mean(ref**2)), 1e-300)))
    d = jax.devices()[0]
    return {
        "metric": "audio_sec_per_sec_per_chip_full_chain",
        "value": round(value, 2),
        "unit": "audio-sec/sec/chip",
        "vs_baseline": round(value / TARGET_RT, 3),
        "accuracy_db": round(float(acc_db), 2),
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(jax.devices())},
    }


if __name__ == "__main__":
    kw = {}
    for a in sys.argv[1:]:
        k, _, v = a.lstrip("-").partition("=")
        if k in ("batch", "iters"):
            kw[k] = int(v)
        elif k == "clip_seconds":
            kw[k] = float(v)
        else:
            sys.exit(f"bench.py: unknown argument {a!r} (known: batch, "
                     "iters, clip_seconds)")
    print(json.dumps(main(**kw)))
