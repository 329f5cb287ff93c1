"""The port's `score` CLI (speech_inpainting_torch/cli/score.py) against the
JAX package's, on the CPU (`--device cpu`).

The metrics are the same host numpy on both sides: PESQ, STOI, ESTOI and
SI-SDR of one pair must be equal within 1e-10. The LSDs read log-mels that
each side computes (the port's ops/mel.py in torch, JAX's in XLA), which
differ by float32 rounding: within 1e-4 dB. The unit IDs of the
mel-centroid encoder (the port's mel and `assign`, JAX's jitted pair) must
be equal, hence UER and masked UER too.
"""
import json
import sys

import numpy as np
import pytest
import torch

from speech_inpainting_tpu.cli import score as jscore
from speech_inpainting_torch.cli import score
from speech_inpainting_torch.data import audio as A

EXACT = ("pesq", "stoi", "estoi", "si_sdr")
LSD = ("lsd_d2", "lsd_rmse")
LSD_ATOL = 1e-4
CPU = ["--device", "cpu"]


def speechy(rng, seconds=1.2, sr=16000):
    """tests/test_cli_score.py's modulated multi-tone."""
    t = np.arange(int(sr * seconds)) / sr
    f0 = 120 + 30 * np.sin(2 * np.pi * 2.1 * t)
    w = sum(0.25 / k * np.sin(2 * np.pi * k * np.cumsum(f0) / sr)
            for k in range(1, 6))
    env = 0.5 + 0.5 * np.square(np.sin(2 * np.pi * 1.7 * t))
    return (w * env).astype(np.float32)


def _same(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        if k in LSD:
            assert abs(got[k] - v) <= LSD_ATOL, (k, got[k], v)
        elif k in EXACT:
            assert abs(got[k] - v) <= 1e-10, (k, got[k], v)
        else:
            assert got[k] == v, (k, got[k], v)


@pytest.mark.parametrize("sr", [16000, 22050])
def test_score_pair_matches_jax(rng, sr):
    ref = speechy(rng, sr=sr)
    noisy = ref + 0.05 * rng.standard_normal(ref.size).astype(np.float32)
    for mode in ("wb", "nb"):
        for deg in (ref.copy(), noisy):
            got = score.score_pair(ref, deg, sr, pesq_mode=mode,
                                   device="cpu")
            _same(got, jscore.score_pair(ref, deg, sr, pesq_mode=mode))
    clean = score.score_pair(ref, ref.copy(), sr, device="cpu")
    deg = score.score_pair(ref, noisy, sr, device="cpu")
    assert clean["pesq"] > deg["pesq"] and clean["lsd_d2"] < 1e-3


def _files(tmp_path, rng, sr=16000):
    ref = speechy(rng, sr=sr)
    noisy = ref + 0.1 * rng.standard_normal(ref.size).astype(np.float32)
    corrupted = ref.copy()          # noise over a third: those units change
    span = slice(ref.size // 3, 2 * ref.size // 3)
    corrupted[span] = 0.3 * rng.standard_normal(
        corrupted[span].size).astype(np.float32)
    gt, out = tmp_path / "gt", tmp_path / "out"
    gt.mkdir(), out.mkdir()
    for name, w in (("a", ref), ("b", noisy), ("c", corrupted)):
        A.save_wav(gt / f"{name}.wav", ref, sr)
        A.save_wav(out / f"{name}.wav", w, sr)
    km = tmp_path / "km.npy"
    np.save(km, rng.standard_normal((8, 80)).astype(np.float32))
    return gt, out, km, (span.start / sr, span.stop / sr)


def test_score_cli_pair_and_dirs_match_jax(tmp_path, rng):
    gt, out, _, _ = _files(tmp_path, rng)
    pair = ["--ref", str(gt / "a.wav"), "--deg", str(out / "b.wav")]
    got = score.main(pair + CPU)
    want = jscore.main(pair)
    assert set(got["files"]) == {"b"}
    _same(got["files"]["b"], want["files"]["b"])

    dirs = ["--ref-dir", str(gt), "--deg-dir", str(out)]
    got = score.main(dirs + CPU + ["--json", str(tmp_path / "s.json")])
    want = jscore.main(dirs + ["--pesq-mode", "wb"])
    assert set(got) == set(want) == {"files", "mean"}
    assert set(got["files"]) == {"a", "b", "c"}
    for name in got["files"]:
        _same(got["files"][name], want["files"][name])
    _same(got["mean"], want["mean"])
    assert json.loads((tmp_path / "s.json").read_text()) == json.loads(
        json.dumps(got))


def test_score_cli_units_match_jax(tmp_path, rng):
    gt, out, km, (t0, t1) = _files(tmp_path, rng)
    mask = f"{t0:.3f}:{t1:.3f}"
    for deg in ("c", "a"):
        args = ["--ref", str(gt / "a.wav"), "--deg", str(out / f"{deg}.wav"),
                "--kmeans", str(km), "--mask", mask]
        got = score.main(args + CPU)["files"][deg]
        _same(got, jscore.main(args)["files"][deg])
        if deg == "c":
            assert got["uer"] > 0.0 and got["uer_mask"] > 0.0
        else:
            assert got["uer"] == got["uer_mask"] == 0.0
    # the unit IDs themselves, at 16 and 22.05 kHz input
    port_units = score._mel_unit_scorer(str(km), "cpu")
    jax_units = jscore._mel_unit_scorer(str(km))
    wav, sr = A.load_wav(out / "c.wav")
    for rate in (sr, 22050):
        w = A.resample(wav, sr, rate)
        np.testing.assert_array_equal(port_units.units(w, rate),
                                      jax_units.units(w, rate))


def test_score_cli_argument_errors(tmp_path, rng):
    """tests/test_cli_score.py:63's refusals, on the port."""
    gt, out, km, _ = _files(tmp_path, rng)
    r, d = str(gt / "a.wav"), str(out / "c.wav")
    bad = [["--ref", r, "--deg", d, "--mask", "0.1:0.2"],   # no --kmeans
           ["--ref", r],                                     # pair XOR dirs
           ["--ref", r, "--deg", d, "--ref-dir", str(gt)],
           ["--ref-dir", str(gt), "--deg-dir", str(out), "--text", "hi"],
           ["--ref", r, "--deg", d, "--kmeans", str(km), "--mask", "0.2"],
           ["--ref", r, "--deg", d, "--kmeans", str(km), "--mask",
            "0.3:0.1"]]
    (tmp_path / "only_deg").mkdir()
    (tmp_path / "empty_ref").mkdir()
    A.save_wav(tmp_path / "only_deg" / "x.wav", speechy(rng), 16000)
    bad.append(["--ref-dir", str(tmp_path / "empty_ref"),
                "--deg-dir", str(tmp_path / "only_deg")])
    for args in bad:
        for main in (score.main, jscore.main):
            with pytest.raises(SystemExit):
                main(args + CPU if main is score.main else args)
    if not torch.cuda.is_available():
        # an entry point: the card unless the CPU is asked for
        with pytest.raises(RuntimeError, match="no CUDA device"):
            score.main(["--ref", r, "--deg", d])


def test_score_cli_text_without_whisper(tmp_path, rng, monkeypatch, capsys):
    gt, out, _, _ = _files(tmp_path, rng)
    monkeypatch.setitem(sys.modules, "transformers", None)
    res = score.main(["--ref", str(gt / "a.wav"), "--deg",
                      str(out / "b.wav"), "--text", "a test"] + CPU)
    assert "note: no local Whisper cache — WER/CER skipped" in \
        capsys.readouterr().out
    assert "wer" not in res["files"]["b"] and "pesq" in res["files"]["b"]
