"""Command-line interface (layer N6 in SURVEY.md §1.2).

Reference analogue: the one-shot generator entry point
(``xm_audio_generator_start`` in ``src/xm_audio_generator.c`` [upstream,
SURVEY.md §2.1]) plus the Android demo flows. Subcommands:

    xmtpu resample in.wav out.wav --rate 16000
    xmtpu mix config.json out.wav
    xmtpu effects in.wav out.wav --chain fx.json
    xmtpu generate config.json out.wav        # full pipeline, progress %
    xmtpu batch manifest.json                  # many clips, bucketed (config 4)
    xmtpu bench [--config N] [--profile DIR]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from xmtpu.utils.errors import XmtpuError


def _check_rate(rate: int, sr: int) -> None:
    """Reject rates the polyphase path cannot sensibly serve (review
    find: --rate 0 used to die with a low-level ZeroDivisionError;
    --rate 44101 designed a ~44101-phase filter bank and hung in a
    massive compile). ONE shared rule with the batch runner
    (ops.resample.check_rates); ConfigError rides the CLI's typed
    error boundary to exit 2."""
    from xmtpu.ops.resample import check_rates

    check_rates(sr, rate)


def _cmd_resample(args) -> int:
    import numpy as np
    from xmtpu import api
    from xmtpu.io import read_wav, write_wav

    pcm, sr = read_wav(args.input)
    _check_rate(args.rate, sr)
    t0 = time.perf_counter()
    out = api.resample(pcm, sr, args.rate)
    dt = time.perf_counter() - t0
    write_wav(args.output, np.asarray(out), args.rate)
    dur = pcm.shape[0] / sr
    print(f"resampled {dur:.2f}s {sr}->{args.rate} Hz in {dt*1e3:.1f} ms "
          f"({dur/dt:.0f}x realtime)")
    return 0


def _cmd_mix(args) -> int:
    from xmtpu import api
    from xmtpu.config.schema import load_config

    cfg = load_config(args.config)
    api.process_file(None, cfg, args.output, progress=_print_progress)
    print()
    return 0


def _cmd_effects(args) -> int:
    import numpy as np
    from xmtpu import api
    from xmtpu.io import read_wav, write_wav

    pcm, sr = read_wav(args.input)
    from xmtpu.config.schema import load_json_source

    # literal-vs-file resolution through THE shared resolver (a literal
    # '{"effects": [...]}' used to be opened as a file path here while
    # every other JSON-taking surface accepted it — review find).
    # fx.build_chain accepts both the {"name", "params"} and flat
    # {"name", <param>...} dict forms.
    chain = load_json_source(args.chain, what="chain")
    if isinstance(chain, dict):
        # accept the wrapped {"effects": [...]} form too (the mixer
        # config's voice-effects vocabulary) — iterating the bare dict
        # used to die with an opaque "dictionary update sequence" error
        if "effects" not in chain:
            raise SystemExit(
                f"{args.chain}: expected a JSON list of effects or an "
                "object with an 'effects' key")
        chain = chain["effects"]
    if args.block_size < 0:
        # a sign typo used to silently disable the block scheduler —
        # the most expensive possible behavior (a whole-clip compile per
        # distinct length) with no signal
        raise SystemExit(
            f"--block-size must be > 0 (or 0 for whole-clip), got "
            f"{args.block_size}")
    bs = args.block_size if args.block_size > 0 else None
    out = api.effects(pcm, sr, chain, block_size=bs)
    write_wav(args.output, np.asarray(out), sr)
    return 0


def _print_progress(pct: float) -> None:
    sys.stdout.write(f"\rprogress: {pct:5.1f}%")
    sys.stdout.flush()


def _cmd_generate(args) -> int:
    return _cmd_mix(args)


def _cmd_bench(args) -> int:
    from xmtpu import benchmarks
    from xmtpu.utils.profiling import trace

    if args.config is None:
        # one SUBPROCESS per config, one after another: configs do not
        # share device state, and a JAX process reserves most of the
        # card's memory, so no two run at once
        import subprocess

        rc = 0
        for k in sorted(benchmarks._CONFIGS):
            cmd = [sys.executable, "-m", "xmtpu.cli", "bench",
                   "--config", str(k)]
            if args.profile:
                cmd += ["--profile", f"{args.profile}/config{k}"]
            rc |= subprocess.run(cmd).returncode
        return rc
    with trace(args.profile):
        benchmarks.run(config=args.config)
    return 0


def _cmd_batch(args) -> int:
    """Batch runner: manifest JSON [{voice, bgm?, out}, ...] (config 4)."""
    from xmtpu.runner import run_batch

    with open(args.manifest) as f:
        jobs = json.load(f)
    rep = run_batch(jobs, sr_in=args.sr_in, sr_bus=args.rate,
                    batch_size=args.batch_size, resume=not args.no_resume,
                    decode_threads=args.decode_threads)
    print(rep.to_json())
    # ANY failed job -> nonzero exit (a 7-of-10 batch is not success;
    # round-2 review find: partial failures used to exit 0)
    return 1 if rep.failed else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="xmtpu",
                                description="Audio preprocessing on JAX (NVIDIA GPU)")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("resample", help="rate-convert a WAV file")
    pr.add_argument("input")
    pr.add_argument("output")
    pr.add_argument("--rate", type=int, required=True)
    pr.set_defaults(fn=_cmd_resample)

    pm = sub.add_parser("mix", help="mix tracks per a JSON config")
    pm.add_argument("config")
    pm.add_argument("output")
    pm.set_defaults(fn=_cmd_mix)

    pe = sub.add_parser("effects", help="apply an effect chain to a WAV")
    pe.add_argument("input")
    pe.add_argument("output")
    pe.add_argument("--chain", required=True,
                    help="JSON effect chain (file path or literal JSON)")
    pe.add_argument(
        "--block-size", type=int, default=131072,
        help="process in carried-state blocks of this many samples "
             "(bounds compile size for long clips and reuses one "
             "executable across clip lengths; 0 = whole-clip)")
    pe.set_defaults(fn=_cmd_effects)

    pg = sub.add_parser("generate", help="one-shot: config -> mixed file")
    pg.add_argument("config")
    pg.add_argument("output")
    pg.set_defaults(fn=_cmd_generate)

    pb = sub.add_parser("bench", help="run the benchmark harness")
    pb.add_argument("--config", type=int, default=None)
    pb.add_argument("--profile", default=None, metavar="TRACE_DIR",
                    help="write a jax.profiler trace (XProf) here")
    pb.set_defaults(fn=_cmd_bench)

    pba = sub.add_parser("batch", help="run a clip manifest (config 4)")
    pba.add_argument("manifest", help="JSON list of {voice, bgm?, out}")
    pba.add_argument("--sr-in", type=int, default=44100, dest="sr_in")
    pba.add_argument("--rate", type=int, default=16000)
    pba.add_argument("--batch-size", type=int, default=64, dest="batch_size")
    pba.add_argument("--no-resume", action="store_true", dest="no_resume")
    pba.add_argument("--decode-threads", type=int, default=1,
                     dest="decode_threads",
                     help="concurrent decode workers (results stay in "
                          "manifest order; outputs identical to 1)")
    pba.set_defaults(fn=_cmd_batch)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except XmtpuError as e:
        # typed errors are BAD USER INPUT (malformed config/chain,
        # undecodable file) — a clean one-line diagnostic, not a
        # traceback (the reference's negative error codes, SURVEY.md
        # §5 failure-detection row; seen live: a chain file with
        # 'type' instead of 'name' dumped a 20-frame traceback)
        print(f"xmtpu: error: {e}", file=sys.stderr)
        return 2
    except FileNotFoundError as e:
        print(f"xmtpu: error: {e}", file=sys.stderr)
        return 2
    except json.JSONDecodeError as e:
        fname = getattr(args, "chain", None) or getattr(
            args, "config", None) or getattr(args, "manifest", "<input>")
        print(f"xmtpu: error: {fname}: invalid JSON: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
