"""The slice as users run it: the port's `predict_ea` CLI on the CPU
(`--device cpu`) against the JAX package's, on the same files: a 1.5 s
wav, a HuBERT-large `CustomModel` state dict (.pt), a narrow V1 `g_*` file
with its config json, and a .npy codebook; the HuBERT config is patched to
a tiny large one (2 layers, hidden 64) on both sides. The generator's
weights carry the signal (`generator_tree(carry=True)`), so that the
inpainted wav differs from hifi_masked. Every wav artifact
agrees to 1 int16 step (the waveforms' f32 gap, ~1e-6, rounds to 0 or 1
step), with `--labels` (expected_inpaint) and with `--long-form` (two
masks). The wav I/O and resampling beside them are held against the JAX
package's exactly (the same numpy and scipy calls)."""
import json

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from speech_inpainting_tpu.cli import predict_ea as jcli
from speech_inpainting_tpu.models.hubert import HubertConfig as JaxHub
from speech_inpainting_torch import testing
from speech_inpainting_torch.cli import predict_ea as cli
from speech_inpainting_torch.models.hifigan import HiFiGANConfig
from speech_inpainting_torch.models.hubert import HubertConfig

HUB = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=128, conv_dim=(32,) * 7,
           num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
GEN = {"resblock": "1", "upsample_rates": [8, 8, 2, 2],
       "upsample_kernel_sizes": [16, 16, 4, 4],
       "upsample_initial_channel": 32, "resblock_kernel_sizes": [3, 7, 11],
       "resblock_dilation_sizes": [[1, 3, 5]] * 3, "num_mels": 80}


class _Tiny:
    """Stands in for a CLI module's HubertConfig: `large()` at tiny widths."""

    def __init__(self, cls):
        self.large = lambda: cls.large(**HUB)
        self.base = lambda: cls.base(**HUB)


@pytest.fixture
def files(tmp_path, monkeypatch):
    monkeypatch.setattr(cli, "HubertConfig", _Tiny(HubertConfig))
    monkeypatch.setattr(jcli, "HubertConfig", _Tiny(JaxHub))
    rng = np.random.default_rng(0)
    cfg = HubertConfig.large(**HUB)
    torch.save(testing.custom_model_state_dict(
        testing.hubert_tree(cfg, 80, rng), cfg), tmp_path / "best.pt")
    gcfg = HiFiGANConfig.from_dict(GEN)
    torch.save({"generator": testing.generator_state_dict(
        testing.generator_tree(gcfg, rng, carry=True), gcfg)},
        tmp_path / "g_00000010")
    (tmp_path / "config.json").write_text(json.dumps(GEN))
    np.save(tmp_path / "km.npy",
            rng.standard_normal((7, 80)).astype(np.float32))
    np.save(tmp_path / "labels.npy", rng.integers(0, 7, 75))
    w22 = testing.synthetic_batch(rng, 1, 1.5)[0][0]
    wavfile.write(tmp_path / "utt.wav", 22050,
                  (w22 * 32767).astype(np.int16))
    return tmp_path


def _args(d, out, *extra):
    return ["--wav", str(d / "utt.wav"), "--hubert-checkpoint",
            str(d / "best.pt"), "--hifigan-checkpoint", str(d / "g_00000010"),
            "--hifigan-config", str(d / "config.json"), "--kmeans",
            str(d / "km.npy"), "--out", str(d / out), *extra]


def _compare(d, names):
    for name in names:
        sr, want = wavfile.read(d / "jax" / "utt" / name)
        sr2, got = wavfile.read(d / "port" / "utt" / name)
        assert sr == sr2 and got.shape == want.shape, name
        assert np.abs(got.astype(np.int32) - want).max() <= 1, name


def test_predict_ea_matches_jax(files):
    extra = ("--start-sec", "0.5", "--end-sec", "0.7", "--labels",
             str(files / "labels.npy"))
    jcli.main(_args(files, "jax", *extra))
    cli.main(_args(files, "port", *extra, "--device", "cpu"))
    wavs = ("orig.wav", "masked.wav", "hifi_masked.wav", "inpainted.wav",
            "expected_inpaint.wav")
    _compare(files, wavs)
    pngs = {p.name for p in (files / "port" / "utt").glob("*.png")}
    assert pngs == {"masked.png", "inpainted.png", "expected.png"}
    # the mask moved the inpainted output off the vocoded masked one
    _, a = wavfile.read(files / "port" / "utt" / "inpainted.wav")
    _, b = wavfile.read(files / "port" / "utt" / "hifi_masked.wav")
    assert not np.array_equal(a, b)


def test_predict_ea_long_form_matches_jax(files):
    extra = ("--long-form", "--mask", "0.3-0.5", "--mask", "1.0-1.2",
             "--window-sec", "0.5")
    jcli.main(_args(files, "jax", *extra))
    cli.main(_args(files, "port", *extra, "--device", "cpu"))
    _compare(files, ("orig.wav", "masked.wav", "inpainted.wav"))
    spans = [json.loads((files / side / "utt" / "spans.json").read_text())
             for side in ("jax", "port")]
    assert spans[0] == spans[1] and len(spans[1]["pasted_sample_spans"]) == 2


def test_predict_ea_runs_on_the_card_unless_asked(files):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(_args(files, "port", "--start-sec", "0.5", "--end-sec",
                       "0.7"))
    (files / "ckpt_dir").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        cli.load_inpainter(cli_args(files, hubert=files / "ckpt_dir"))


def cli_args(d, hubert):
    import argparse
    return argparse.Namespace(
        kmeans=str(d / "km.npy"), hubert_type="large",
        hifigan_config=str(d / "config.json"), device="cpu",
        hubert_checkpoint=str(hubert),
        hifigan_checkpoint=str(d / "g_00000010"))


def test_audio_io_matches_jax(tmp_path):
    from speech_inpainting_tpu.data import audio as jaudio
    from speech_inpainting_torch.data import audio
    rng = np.random.default_rng(3)
    x = (0.9 * np.sin(np.arange(22050) / 7.0) + 0.05 * rng.standard_normal(
        22050)).astype(np.float32)
    x[10] = 1.5                                   # clipped on write
    audio.save_wav(tmp_path / "port.wav", x, 22050)
    jaudio.save_wav(tmp_path / "jax.wav", x, 22050)
    assert (tmp_path / "port.wav").read_bytes() == \
        (tmp_path / "jax.wav").read_bytes()
    for sr in (None, 16000, 22050):
        got, gsr = audio.load_wav(tmp_path / "port.wav", sr)
        want, wsr = jaudio.load_wav(tmp_path / "port.wav", sr)
        assert gsr == wsr and got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(audio.resample(x, 22050, 16000),
                                  jaudio.resample(x, 22050, 16000))
