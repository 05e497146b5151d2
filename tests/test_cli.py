"""CLI surface tests (in-process main(), CPU-friendly shapes)."""

from __future__ import annotations

import json

import numpy as np
import pytest

import xmtpu  # noqa: F401
from xmtpu.cli import main
from xmtpu.io.wav import read_wav, write_wav


@pytest.fixture()
def tone(tmp_path):
    sr = 44100
    t = np.arange(sr) / sr
    pcm = (np.sin(2 * np.pi * 440 * t) * 12000).astype(np.int16)
    p = tmp_path / "tone.wav"
    write_wav(str(p), pcm, sr)
    return str(p), sr


def test_cli_resample(tone, tmp_path):
    inp, sr = tone
    out = str(tmp_path / "out16k.wav")
    assert main(["resample", inp, out, "--rate", "16000"]) == 0
    pcm, got_sr = read_wav(out)
    assert got_sr == 16000 and pcm.shape[0] == 16000


def test_cli_effects(tone, tmp_path):
    inp, sr = tone
    chain = [{"name": "volume", "params": {"gain_db": -6.0}}]
    cpath = tmp_path / "chain.json"
    cpath.write_text(json.dumps(chain))
    out = str(tmp_path / "fx.wav")
    assert main(["effects", inp, out, "--chain", str(cpath)]) == 0
    got, _ = read_wav(out)
    ref, _ = read_wav(inp)
    ratio = np.max(np.abs(got)) / np.max(np.abs(ref))
    assert abs(20 * np.log10(ratio) + 6.0) < 0.1


def test_cli_effects_literal_chain(tone, tmp_path):
    """--chain accepts a LITERAL JSON string through the shared
    schema.load_json_source resolver — it used to be opened as a file
    path here while every other JSON surface accepted literals
    (verify-drive find 2026-08-19)."""
    inp, sr = tone
    out = str(tmp_path / "fxl.wav")
    lit = json.dumps([{"name": "volume", "params": {"gain_db": -6.0}}])
    assert main(["effects", inp, out, "--chain", lit]) == 0
    got, _ = read_wav(out)
    ref, _ = read_wav(inp)
    ratio = np.max(np.abs(got)) / np.max(np.abs(ref))
    assert abs(20 * np.log10(ratio) + 6.0) < 0.1


def test_cli_effects_wrapped_chain(tone, tmp_path):
    """The CLI also accepts {"effects": [...]} (the mixer config's
    voice-effects vocabulary); a dict without that key exits with a
    named error instead of an opaque traceback (review/verify find)."""
    import pytest

    inp, sr = tone
    cpath = tmp_path / "chain_wrapped.json"
    cpath.write_text(json.dumps(
        {"effects": [{"name": "volume", "params": {"gain_db": -6.0}}]}))
    out = str(tmp_path / "fxw.wav")
    assert main(["effects", inp, out, "--chain", str(cpath)]) == 0
    got, _ = read_wav(out)
    ref, _ = read_wav(inp)
    ratio = np.max(np.abs(got)) / np.max(np.abs(ref))
    assert abs(20 * np.log10(ratio) + 6.0) < 0.1
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"not_effects": []}))
    with pytest.raises(SystemExit, match="effects"):
        main(["effects", inp, out, "--chain", str(bad)])


def test_cli_typed_errors_clean_exit(tone, tmp_path, capsys):
    """Bad user input (malformed chain entries, invalid JSON, missing
    files) exits 2 with a one-line 'xmtpu: error:' diagnostic — never a
    traceback (verify-session find: a chain entry keyed 'type' instead
    of 'name' dumped a raw ConfigError traceback)."""
    inp, sr = tone
    out = str(tmp_path / "never.wav")
    # ConfigError: wrong vocabulary key inside an otherwise-valid file
    cpath = tmp_path / "bad_key.json"
    cpath.write_text(json.dumps([{"type": "volume", "gain_db": -6.0}]))
    assert main(["effects", inp, out, "--chain", str(cpath)]) == 2
    err = capsys.readouterr().err
    assert err.startswith("xmtpu: error:") and "name" in err
    # invalid JSON
    jpath = tmp_path / "not_json.json"
    jpath.write_text("{nope")
    assert main(["effects", inp, out, "--chain", str(jpath)]) == 2
    assert "invalid chain JSON" in capsys.readouterr().err
    # missing input file
    assert main(["resample", str(tmp_path / "ghost.wav"), out,
                 "--rate", "16000"]) == 2
    assert "xmtpu: error:" in capsys.readouterr().err


def test_cli_generate(tone, tmp_path):
    inp, sr = tone
    cfg = {"sampleRate": 16000,
           "tracks": [{"url": inp, "volume": 0.8}]}
    cpath = tmp_path / "cfg.json"
    cpath.write_text(json.dumps(cfg))
    out = str(tmp_path / "gen.wav")
    assert main(["generate", str(cpath), out]) == 0
    got, got_sr = read_wav(out)
    assert got_sr == 16000 and got.shape[0] == 16000


def test_cli_batch(tone, tmp_path):
    inp, sr = tone
    manifest = [{"voice": inp, "out": str(tmp_path / "b0.wav")}]
    mpath = tmp_path / "manifest.json"
    mpath.write_text(json.dumps(manifest))
    assert main(["batch", str(mpath)]) == 0
    got, got_sr = read_wav(str(tmp_path / "b0.wav"))
    assert got_sr == 16000 and got.shape[0] == 16000


def test_cli_unknown_subcommand():
    with pytest.raises(SystemExit):
        main(["frobnicate"])


def test_cli_effects_flat_params(tone, tmp_path):
    """Chain entries without a nested "params" dict (the api.effects
    flat form) must work through the CLI too (round-2 /verify find)."""
    inp, _sr = tone
    out = str(tmp_path / "fx_flat.wav")
    chain = [
        {"name": "equalizer",
         "bands": [{"freq_hz": 300.0, "gain_db": 3.0, "q": 1.0}]},
        {"name": "limiter", "threshold_db": -3.0},
    ]
    cpath = tmp_path / "chain_flat.json"
    cpath.write_text(json.dumps(chain))
    assert main(["effects", inp, out, "--chain", str(cpath)]) == 0
    pcm, sr = read_wav(out)
    assert np.asarray(pcm).size > 0


def test_equalizer_requires_bands():
    """A band-less equalizer config raises ConfigError, not a crash
    deep inside the scan (round-2 /verify find)."""
    import pytest as _pytest
    from xmtpu.graph import fx as _fx
    from xmtpu.utils.errors import ConfigError

    with _pytest.raises(ConfigError):
        _fx.build_chain(16000, [{"name": "equalizer"}])


def test_sosfilt_scan_empty_cascade_is_identity(rng):
    """S=0 sos: identity output, (0, ..., 2) state."""
    from xmtpu.ops import biquad as _biquad
    import jax.numpy as jnp

    x = rng.standard_normal((2, 64)).astype(np.float32)
    y, zf = _biquad.sosfilt_scan(np.zeros((0, 6)), jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(y), x)
    assert zf.shape == (0, 2, 2)


def test_cli_batch_partial_failure_exit_code(tone, tmp_path):
    """ANY failed job makes `xmtpu batch` exit nonzero (round-2 review
    find: 7-of-10 partial failure used to exit 0)."""
    inp, _ = tone
    jobs = [
        {"voice": inp, "out": str(tmp_path / "ok.wav")},
        {"voice": str(tmp_path / "missing.wav"),
         "out": str(tmp_path / "bad.wav")},
    ]
    mpath = tmp_path / "m.json"
    mpath.write_text(json.dumps(jobs))
    rc = main(["batch", str(mpath), "--rate", "16000"])
    assert rc == 1


def test_effects_missing_name_raises_config_error():
    from xmtpu.graph import fx as _fx
    from xmtpu.utils.errors import ConfigError

    with pytest.raises(ConfigError):
        _fx.build_chain(16000, [{"params": {"gain_db": -6.0}}])
