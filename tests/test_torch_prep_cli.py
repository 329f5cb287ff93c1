"""Data preparation (cli/prep.py and what it runs: data/audio.py's trim
and pad, ops/mel.py's HTK filterbank and full-band 16 kHz preset,
data/wav2mel.py, utils/kaldi.py) against the JAX package's, on the CPU.

Each prep subcommand but `download` (test_torch_download.py) runs in both
CLIs on one tiny corpus
written to a temporary directory, and the files are compared: the wavs,
manifests, splits, unit files and summaries byte for byte; features and
f0 statistics within float32 rounding (rtol 1e-5, atol 1e-5 of features
of unit scale; the f0 means and deviations within the tracker's
tolerance, rel 2e-3). HuBERT is a small random model: the port reads it
from an HF-layout directory (convert/hubert_torch.py), the JAX CLI gets
the same tree through its loader, patched (no `transformers` import).
Unit files must be equal; the centroids are a k-means fit of the
features, and the test asserts that every frame's nearest centroid wins
by more than float32 rounding.
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import speech_inpainting_tpu.convert.hubert_torch as jhubert_torch
from speech_inpainting_tpu.cli import prep as jprep
from speech_inpainting_tpu.data import audio as jaudio
from speech_inpainting_tpu.data import wav2mel as jw2m
from speech_inpainting_tpu.models.hubert import HubertConfig as JHubertConfig
from speech_inpainting_tpu.ops import mel as jmel
from speech_inpainting_tpu.utils import kaldi as jkaldi
from speech_inpainting_torch import testing
from speech_inpainting_torch.cli import prep as pprep
from speech_inpainting_torch.data import audio as paudio
from speech_inpainting_torch.data import wav2mel as pw2m
from speech_inpainting_torch.models.hubert import HubertConfig
from speech_inpainting_torch.ops import mel as pmel
from speech_inpainting_torch.quantize.kmeans import fit_kmeans
from speech_inpainting_torch.utils import kaldi as pkaldi
from test_torch_ida import HUB


def _synthetic(rng, seconds, sr, lead=0.3):
    """An utterance with `lead` seconds of near-silence before and after."""
    x = testing.synthetic_utterance(rng, seconds, sr)
    quiet = (rng.standard_normal(int(lead * sr)) * 1e-4).astype(np.float32)
    return np.concatenate([quiet, x, quiet])


def test_trim_and_pad_are_bit_equal():
    rng = np.random.default_rng(0)
    for n in (1000, 20000, 33333):
        x = _synthetic(rng, n / 16000, 16000)
        for top_db in (20.0, 40.0):
            np.testing.assert_array_equal(
                paudio.trim_silence(x, top_db=top_db),
                jaudio.trim_silence(x, top_db=top_db))
        np.testing.assert_array_equal(paudio._frame_rms(x, 2048, 512),
                                      jaudio._frame_rms(x, 2048, 512))
        for m in (1280, 7):
            got = paudio.pad_to_multiple(x, m)
            np.testing.assert_array_equal(got, jaudio.pad_to_multiple(x, m))
            assert len(got) % m == 0
    z = np.zeros(4000, np.float32)
    np.testing.assert_array_equal(paudio.trim_silence(z),
                                  jaudio.trim_silence(z))
    assert len(paudio.trim_silence(z[:0])) == 0


def test_load_flac_matches_jax(tmp_path):
    """The native decoder through both packages' `load_flac`: a stereo
    16-bit stream at 48 kHz, as decoded and resampled to 16 kHz,
    bit-equal."""
    from flac_fixture import encode
    rng = np.random.default_rng(8)
    left = np.cumsum(rng.integers(-200, 200, 4800))
    left = np.clip(left, -30000, 30000)
    path = tmp_path / "st.flac"
    path.write_bytes(encode([left, left // 2], sr=48000,
                            modes=["fixed2", "lpc1"]))
    for target in (None, 16000):
        got, sr = paudio.load_flac(path, target_sr=target)
        want, want_sr = jaudio.load_flac(path, target_sr=target)
        assert sr == want_sr == (target or 48000)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_htk_filterbank_and_fullband_mel():
    for args in ((16000, 400, 80, 50.0, None), (22050, 1024, 40, 0.0, 8000.)):
        for kw in ({"htk": True}, {"htk": True, "norm": "slaney"},
                   {"htk": False, "norm": None}):
            np.testing.assert_array_equal(pmel.mel_filterbank(*args, **kw),
                                          jmel.mel_filterbank(*args, **kw))
    cfg_p, cfg_j = pmel.VOCODER_MEL_16K_FULLBAND, jmel.VOCODER_MEL_16K_FULLBAND
    assert cfg_p.fmax is None and cfg_p.sampling_rate == 16000
    y = np.random.default_rng(1).standard_normal((2, 8000)).astype(
        np.float32) * 0.3
    np.testing.assert_allclose(
        pmel.mel_spectrogram(torch.tensor(y), cfg_p).numpy(),
        np.asarray(jmel.mel_spectrogram(jnp.asarray(y), cfg_j)),
        atol=1e-5, rtol=1e-4)


def test_wav2mel_matches_jax():
    """The silence removal and −3 dB norm bit-equal; the HTK log-mel
    (time, 80) within float32 rounding (atol 2e-3 in the log of quiet
    bins, as in tests/test_torch_code_dataset.py), from a stereo 22.05 kHz
    input."""
    rng = np.random.default_rng(3)
    x = _synthetic(rng, 1.0, 22050)
    x[int(0.6 * 22050):int(0.8 * 22050)] = 0.0     # a 0.2 s silent run
    np.testing.assert_array_equal(pw2m.norm_db(x, -3.0),
                                  jw2m.norm_db(x, -3.0))
    np.testing.assert_array_equal(pw2m.remove_silence(x, 22050),
                                  jw2m.remove_silence(x, 22050))
    stereo = np.stack([x, 0.5 * x])
    got = pw2m.Wav2Mel(device="cpu")(stereo, 22050)
    want = jw2m.Wav2Mel()(stereo, 22050)
    assert got.shape == want.shape and got.shape[1] == 80
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)


def test_kaldi_round_trip_and_cross_read(tmp_path):
    rng = np.random.default_rng(4)
    mats = [("utt1", rng.standard_normal((5, 3)).astype(np.float32)),
            ("utt2", rng.standard_normal((2, 4))),          # float64 → DM
            ("utt3", np.zeros((0, 3), np.float32))]
    ark_p, scp_p = pkaldi.write_mats(mats, tmp_path / "p" / "feats")
    ark_j, scp_j = jkaldi.write_mats(mats, tmp_path / "j" / "feats")
    assert ark_p.read_bytes() == ark_j.read_bytes()
    for reader, ark, scp in ((pkaldi, ark_j, scp_j), (jkaldi, ark_p, scp_p),
                             (pkaldi, ark_p, scp_p)):
        for got in (reader.read_ark(ark), reader.read_scp(scp)):
            assert list(got) == ["utt1", "utt2", "utt3"]
            for key, m in mats:
                np.testing.assert_array_equal(got[key], m)
                assert got[key].dtype == (np.float64 if m.dtype == np.float64
                                          else np.float32)
    for bad in ([("a b", np.zeros((1, 1)))], [("a", np.zeros(3))]):
        with pytest.raises(ValueError):
            pkaldi.write_mats(bad, tmp_path / "bad")


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """Six 22.05 kHz wavs of three speakers and three texts, padded with
    near-silence for `preprocess` to trim."""
    root = tmp_path_factory.mktemp("raw")
    (root / "sub").mkdir()
    rng = np.random.default_rng(6)
    for spk in ("p225", "p226", "p227"):
        for txt in ("001", "002"):
            where = root / "sub" if spk == "p227" else root
            paudio.save_wav(where / f"{spk}_{txt}.wav",
                            _synthetic(rng, rng.uniform(1.0, 1.3), 22050),
                            22050)
    return root


def _files(d):
    return {p.relative_to(d).as_posix(): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


def test_prep_subcommands_write_what_jax_writes(raw, tmp_path, monkeypatch,
                                                capsys):
    out = {side: tmp_path / side for side in ("p", "j")}
    run = {"p": pprep.main, "j": jprep.main}

    def both(*args, device=False):
        """Run `args` in each CLI, {side} in them naming its directory."""
        said = {}
        for side in "pj":
            argv = [str(a).format(side=out[side]) for a in args]
            if device and side == "p":
                argv += ["--device", "cpu"]
            run[side](argv)
            said[side] = capsys.readouterr().out.replace(str(out[side]), "")
        return said

    both("preprocess", "--root", raw, "--out", "{side}/wavs")
    wavs = _files(out["p"] / "wavs")
    assert len(wavs) == 6 and wavs == _files(out["j"] / "wavs")
    # the rest runs on one set of wavs, so that paths inside files agree
    corpus = out["p"] / "wavs"
    both("manifest", "--root", corpus, "--dest", "{side}/m",
         "--valid-percent", "0.3")
    assert _files(out["p"] / "m") == _files(out["j"] / "m")
    tsv = out["p"] / "m" / "train.tsv"

    hcfg = HubertConfig(**HUB)
    hub = testing.hubert_model_tree(hcfg, np.random.default_rng(7))
    testing.write_hf_hubert(tmp_path / "hubert", hub, hcfg)
    monkeypatch.setattr(jhubert_torch, "load_hf_pretrained",
                        lambda path: (JHubertConfig(**HUB), hub))
    both("features", "--manifest", tsv, "--hubert", tmp_path / "hubert",
         "--layer", 1, "--out", "{side}/feats/train.npy", "--kaldi",
         "{side}/feats/kaldi", device=True)
    got = np.load(out["p"] / "feats" / "train.npy")
    want = np.load(out["j"] / "feats" / "train.npy")
    assert got.shape == want.shape and got.shape[1] == HUB["hidden_size"]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert ((out["p"] / "feats" / "train.tsv").read_bytes()
            == tsv.read_bytes())
    ark_p = pkaldi.read_scp(out["p"] / "feats" / "kaldi.scp")
    ark_j = pkaldi.read_scp(out["j"] / "feats" / "kaldi.scp")
    assert list(ark_p) == list(ark_j)
    for k in ark_p:
        np.testing.assert_allclose(ark_p[k], ark_j[k], rtol=1e-5, atol=1e-5)
    # --sample-pct draws the same rows
    both("features", "--manifest", tsv, "--hubert", tmp_path / "hubert",
         "--layer", 1, "--out", "{side}/half/train.npy", "--sample-pct",
         "0.5", "--seed", "3", device=True)
    assert (np.load(out["p"] / "half" / "train.npy").shape
            == np.load(out["j"] / "half" / "train.npy").shape)

    # a k-means codebook of the features (the port's fit, as kmeans_cli
    # fits it); every frame's nearest centroid wins by 1e-4 of the
    # distance, far above float32 rounding (~1e-6 of it)
    centroids, _ = fit_kmeans(want, 4, iters=20, device="cpu")
    centroids = centroids.numpy()
    np.save(tmp_path / "km.npy", centroids)
    d = ((want[:, None, :] - centroids[None]) ** 2).sum(-1)
    d.sort(axis=1)
    assert (d[:, 1] - d[:, 0] > 1e-4 * d[:, 1]).all()
    both("quantize", "--manifest", tsv, "--hubert", tmp_path / "hubert",
         "--layer", 1, "--kmeans", tmp_path / "km.npy", "--out",
         "{side}/units.txt", device=True)
    units = (out["p"] / "units.txt").read_text()
    assert units == (out["j"] / "units.txt").read_text()
    assert len(units.splitlines()) == len(tsv.read_text().splitlines()) - 1

    both("parse-codes", "--manifest", tsv, "--units", out["p"] / "units.txt",
         "--outdir", "{side}/codes", "--valid-percent", "0.2",
         "--test-percent", "0.2")
    assert _files(out["p"] / "codes") == _files(out["j"] / "codes")

    manifest = out["p"] / "codes" / "train.txt"
    both("f0-stats", "--manifest", manifest, "--out", "{side}/f0.json",
         device=True)
    got = json.loads((out["p"] / "f0.json").read_text())
    want = json.loads((out["j"] / "f0.json").read_text())
    assert got["speakers"] == want["speakers"]
    assert sorted(got["stats"]) == sorted(want["stats"])
    for k, s in want["stats"].items():
        for field in ("f0_mean", "f0_std"):
            np.testing.assert_allclose(got["stats"][k][field], s[field],
                                       rtol=2e-3, err_msg=f"{k} {field}")

    for regime in ("ratio", "speakers", "texts", "both"):
        said = both("splits", "--root", corpus, "--dest",
                    "{side}/splits_" + regime, "--regime", regime,
                    "--ratio", "0.5", "--exclude-speaker", "p999")
        assert said["p"] == said["j"]
        assert (_files(out["p"] / f"splits_{regime}")
                == _files(out["j"] / f"splits_{regime}"))
    said = both("summary", "--dest", "{side}/splits_both")
    assert said["p"] == said["j"] and "common unique speakers" in said["p"]
    # `download` is held against JAX's in test_torch_download.py; here,
    # with --skip-download and no archive under --root, it fetches nothing
    # and fails on the missing archive
    with pytest.raises(FileNotFoundError):
        pprep.main(["download", "--dataset", "VCTK", "--root",
                    str(tmp_path / "corpora"), "--skip-download"])
