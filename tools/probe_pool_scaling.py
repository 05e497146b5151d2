"""Chip probe: SessionPool serving-aggregate scaling over K (where is
the serving ceiling, and are the oracle-grade scans the binding cost at
higher K?).

Usage:
    python tools/probe_pool_scaling.py [K ...] [backend=scan|gpu]

Defaults: K in {32, 64, 128}, backend=scan. Each K builds the config-5
pipeline (1 voice track 44.1k->16k + EQ + limiter master chain), warms
two 50-frame groups, then times 3 groups (each ``read`` ends in a host
fetch of its frames). Prints one JSON line per K, with the device.

Interpretation: near-linear aggregate growth with K means the device
step is NOT the binding cost (dispatch and fetch are) and the f64 scans
are fine; saturation means the step binds and the card's engine
(``backend=gpu``, the envelope kernel) becomes worth comparing.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ks, backend = [], "scan"
    for a in sys.argv[1:]:
        if a.startswith("backend="):
            backend = a.split("=", 1)[1]
        else:
            ks.append(int(a))
    ks = ks or [32, 64, 128]

    import jax

    from xmtpu.config.schema import EffectConfig, PipelineConfig, TrackConfig
    from xmtpu.graph.pool import SessionPool

    sr = 16000
    rng = np.random.default_rng(0)
    cfg = PipelineConfig(
        tracks=(TrackConfig(url="v"),),
        master_effects=(
            EffectConfig("equalizer", {"bands": [
                {"freq_hz": 300.0, "gain_db": 2.0, "q": 1.0}]}),
            EffectConfig("limiter", {}),
        ),
        sample_rate=sr, normalize=None,
    )
    n_v = int(44100 * 8.0)
    for K in ks:
        srcs = [{"v": ((0.3 * rng.standard_normal(n_v)).astype(np.float32),
                       44100)} for _ in range(K)]
        pool = SessionPool(cfg, K, frame_ms=20.0, sources=srcs,
                           effects_backend=backend)
        kp = 50  # 1 s groups
        pool.read(kp)  # compile + fill prefetch
        pool.read(kp)
        t0 = time.perf_counter()
        audio = 0.0
        for _ in range(3):
            out = pool.read(kp)
            audio += out.shape[0] * out.shape[1] / pool.sr
        dt = time.perf_counter() - t0
        d = jax.devices()[0]
        print(json.dumps({"K": K, "backend": backend,
                          "device": {"platform": d.platform,
                                     "kind": d.device_kind},
                          "aggregate_audio_sec_per_sec": round(audio / dt, 1),
                          "x_realtime_per_session": round(audio / dt / K, 2)}))
        del pool, srcs


if __name__ == "__main__":
    main()
