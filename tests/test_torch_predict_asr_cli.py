"""The port's ASR→TTS baseline CLI (speech_inpainting_torch/cli/
predict_asr.py) and its in-house TTS leg (`infer/asr_baseline.py:
UnitResynthTTS` over the port's `IdaInpainter`), on the CPU in float32.

  - `--synth`: the splice chain is host numpy on both sides, so every
    artifact must equal the JAX CLI's (tests/test_cli_baseline.py:17's
    inputs);
  - `UnitResynthTTS` against JAX's, over two `IdaInpainter`s built from the
    same small trees (tests/test_torch_ida.py's geometry, a 16-wide
    d-vector): the rendering within the I_da waveform tolerance, atol 1e-4,
    its units equal;
  - `--donor`: JAX's own donor test reads the reference's checkpoints,
    which the repository does not hold, so the port's CLI is held to a direct port call on the same
    files: `output_tts.wav` and the splice within 1 int16 step (the wav
    files' rounding).
"""
import json

import numpy as np
import pytest
import torch

from speech_inpainting_tpu.cli import predict_asr as jcli
from speech_inpainting_tpu.convert import hubert_torch as jhub
from speech_inpainting_tpu.convert import ida_torch as jida
from speech_inpainting_tpu.data.code_dataset import (
    mel_stats_embedder as jax_embedder)
from speech_inpainting_tpu.infer.asr_baseline import (
    UnitResynthTTS as JaxUnitResynthTTS)
from speech_inpainting_tpu.infer.ida_inpaint import IdaInpainter as JaxIda
from speech_inpainting_tpu.models import codegen as jcodegen
from speech_inpainting_tpu.models.hubert import HubertConfig as JaxHub
from speech_inpainting_torch import testing
from speech_inpainting_torch.cli import predict_asr
from speech_inpainting_torch.convert.from_jax import hubert_model_from_jax
from speech_inpainting_torch.data import audio as A
from speech_inpainting_torch.data.code_dataset import mel_stats_embedder
from speech_inpainting_torch.infer.asr_baseline import (ASRBaselineConfig,
                                                        UnitResynthTTS,
                                                        asr_tts_baseline)
from speech_inpainting_torch.infer.ida_inpaint import IdaInpainter
from speech_inpainting_torch.models import codegen
from speech_inpainting_torch.models.hubert import HubertConfig
from test_torch_ida import HUB
from test_torch_ida_cli import IDA

SR = 16000
WAVE = 1e-4
ARTIFACTS = ("orig.wav", "output_tts.wav", "mask_synth_stretched.wav",
             "inpainted.wav", "inpainted_with_silence.wav")


def _tone(f, seconds, amp=0.3):
    t = np.arange(int(SR * seconds)) / SR
    return (amp * np.sin(2 * np.pi * f * t)).astype(np.float32)


def _steps(a, b) -> int:
    x, y = A.load_wav(a)[0], A.load_wav(b)[0]
    assert x.shape == y.shape, (a, b)
    return int(np.abs(np.round((x - y) * 32768)).max()) if x.size else 0


def test_synth_path_matches_jax(tmp_path):
    y = _tone(150, 2.0)
    masked = y.copy()
    masked[int(0.8 * SR):int(1.1 * SR)] = 0.0
    A.save_wav(tmp_path / "masked.wav", masked, SR)
    A.save_wav(tmp_path / "tts.wav", _tone(190, 2.0), SR)
    for crop in ([], ["--no-crop-silence"]):
        args = ["--input", str(tmp_path / "masked.wav"), "--mask", "0.8:1.1",
                "--synth", str(tmp_path / "tts.wav"), "--transcript",
                "a test sentence", *crop]
        got = predict_asr.main(args + ["--out", str(tmp_path / "port"),
                                       "--device", "cpu"])
        want = jcli.main(args + ["--out", str(tmp_path / "jax")])
        names = sorted(p.name for p in (tmp_path / "port").iterdir())
        assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
        assert set(ARTIFACTS) | {"transcript.txt"} == set(names)
        for name in ARTIFACTS:
            assert _steps(tmp_path / "port" / name,
                          tmp_path / "jax" / name) == 0, name
        assert (tmp_path / "port" / "transcript.txt").read_text() == \
            "a test sentence\n"
        np.testing.assert_array_equal(got["target_span_s"],
                                      want["target_span_s"])
    inp, _ = A.load_wav(tmp_path / "port" / "inpainted_with_silence.wav")
    assert float(np.abs(inp[int(0.8 * SR) + 400:int(1.1 * SR) - 400])
                 .mean()) > 0.05              # the mask is no longer silent


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """tests/test_torch_ida_cli.py's small I_da stack as a user's files:
    config JSON, a reference-layout CodeGenerator g_, an HF HuBERT
    directory, a .npy codebook of layer-1 features of the donor (clear
    nearest units), a donor and a speaker wav."""
    d = tmp_path_factory.mktemp("stack")
    rng = np.random.default_rng(7)
    cfg = codegen.CodeGeneratorConfig.from_dict(IDA)
    params, vq = testing.codegen_tree(cfg, rng)
    params["fo_vqvae"]["decoder"] = testing.jukebox_tree(
        cfg.f0_quantizer.decoder, rng, decoder=True)
    sd = testing.code_generator_state_dict(params, vq, cfg)
    torch.save({"generator": sd}, d / "g_00000001")
    hcfg = HubertConfig(**HUB)
    hp = testing.hubert_model_tree(hcfg, rng)
    testing.write_hf_hubert(d / "hubert", hp, hcfg)
    (d / "cfg.json").write_text(json.dumps(IDA))
    A.save_wav(d / "donor.wav", testing.synthetic_utterance(rng, 2.4), SR)
    A.save_wav(d / "speaker.wav", testing.synthetic_utterance(rng, 1.6), SR)
    donor = A.load_wav(d / "donor.wav")[0]
    hub = hubert_model_from_jax(hcfg, hp, device="cpu")
    with torch.no_grad():
        pool = hub(torch.tensor(donor)[None], tap_layer=1)[0].numpy()
    centroids = pool[rng.choice(len(pool), 10, replace=False)]
    np.save(d / "km.npy", centroids)
    return dict(dir=d, sd=sd, hp=hp, centroids=centroids, pool=pool)


def _port_tts(s, device="cpu"):
    """The port's TTS leg from the stack's files, as the CLI loads it."""
    args = type("Args", (), dict(
        config=str(s["dir"] / "cfg.json"),
        codegen_checkpoint=str(s["dir"] / "g_00000001"),
        hubert=str(s["dir"] / "hubert"), kmeans=str(s["dir"] / "km.npy"),
        layer=1, device=device))
    return predict_asr._build_unit_tts(args)


def test_unit_resynth_tts_matches_jax(stack):
    jcfg = jcodegen.CodeGeneratorConfig.from_dict(IDA)
    jp, jvq = jida.convert_code_generator(stack["sd"], jcfg)
    jhp = jhub.convert_hf_hubert(
        testing.hubert_state_dict(stack["hp"], HubertConfig(**HUB)),
        JaxHub(**HUB))
    ref = JaxIda(jcfg, jp, jvq, JaxHub(**HUB), jhp, stack["centroids"],
                 tap_layer=1, code_hop=320)
    d = np.sort(((stack["pool"][:, None] - stack["centroids"][None]) ** 2)
                .sum(-1), axis=-1)[:, :2]
    assert (d[:, 1] - d[:, 0]).min() > 1e-3        # units far from a tie
    port = _port_tts(stack)
    donor = A.load_wav(stack["dir"] / "donor.wav")[0]
    speaker = A.load_wav(stack["dir"] / "speaker.wav")[0]
    np.testing.assert_allclose(mel_stats_embedder(16, device="cpu")(
        speaker, SR), jax_embedder(16)(speaker, SR), atol=1e-6)
    for kw, jkw in (
            ({"embedder": mel_stats_embedder(16, device="cpu")},
             {"embedder": jax_embedder(16)}),
            ({"emb": np.full(16, 0.25, np.float32)},
             {"emb": np.full(16, 0.25, np.float32)})):
        got = UnitResynthTTS(port._inp, **kw)(donor, speaker)
        want = np.asarray(JaxUnitResynthTTS(ref, **jkw)(donor, speaker))
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        assert got.shape == want.shape and got.shape[0] % 1280 == 0
        np.testing.assert_allclose(got, want, atol=WAVE, rtol=0)
        assert np.abs(got).max() > 1e-3            # rendered, not silence
    emb = np.full(16, 0.25, np.float32)
    units = port._inp(donor, 0, emb=emb)["code_clean"].numpy()
    np.testing.assert_array_equal(
        units, np.asarray(ref(donor, 0, emb=emb)["code_clean"]))


def test_donor_path_matches_a_direct_call(stack, tmp_path):
    s = stack["dir"]
    y = testing.synthetic_utterance(np.random.default_rng(3), 2.4)
    masked = y.copy()
    masked[int(0.9 * SR):int(1.2 * SR)] = 0.0
    A.save_wav(tmp_path / "masked.wav", masked, SR)
    out = tmp_path / "base"
    res = predict_asr.main([
        "--input", str(tmp_path / "masked.wav"), "--mask", "0.9:1.2",
        "--donor", str(s / "donor.wav"), "--config", str(s / "cfg.json"),
        "--codegen-checkpoint", str(s / "g_00000001"),
        "--hubert", str(s / "hubert"), "--layer", "1",
        "--kmeans", str(s / "km.npy"), "--out", str(out),
        "--speaker-wav", str(s / "speaker.wav"), "--device", "cpu"])
    assert {p.name for p in out.iterdir()} == set(ARTIFACTS) | {
        "speaker_wav.wav", "transcript.txt"}
    assert (out / "transcript.txt").read_text() == "<donor:donor.wav>\n"
    # the same files through the port directly
    donor = A.load_wav(s / "donor.wav", target_sr=SR)[0]
    speaker = A.load_wav(s / "speaker.wav", target_sr=SR)[0]
    synth = _port_tts(stack)(donor, speaker)
    direct = asr_tts_baseline(A.load_wav(tmp_path / "masked.wav")[0],
                              (0.9, 1.2), y_synth=synth,
                              transcript=res["transcript"],
                              speaker_wav=speaker, cfg=ASRBaselineConfig())
    for name, wav in (("output_tts.wav", synth),
                      ("mask_synth_stretched.wav", direct["patch"]),
                      ("inpainted.wav", direct["inpainted"]),
                      ("inpainted_with_silence.wav",
                       direct["inpainted_with_silence"])):
        A.save_wav(tmp_path / "direct.wav", wav, SR)
        assert _steps(out / name, tmp_path / "direct.wav") <= 1, name
    assert np.abs(A.load_wav(out / "output_tts.wav")[0]).max() > 1e-3


def test_argument_validation(stack, tmp_path):
    """tests/test_cli_baseline.py:74's refusals, on the port, and the
    device rule of its entry points."""
    A.save_wav(tmp_path / "m.wav", _tone(150, 1.0), SR)
    m = str(tmp_path / "m.wav")
    bad = [["--input", m, "--mask", "0.2:0.4", "--out", str(tmp_path)],
           ["--input", m, "--mask", "0.2:0.4", "--synth", m, "--donor", m,
            "--out", str(tmp_path)],
           ["--input", m, "--mask", "0.2:0.4", "--donor", m, "--out",
            str(tmp_path)],
           ["--input", m, "--mask", "0.4", "--synth", m, "--out",
            str(tmp_path)],
           ["--input", m, "--mask", "0.4:0.2", "--synth", m, "--out",
            str(tmp_path)],
           ["--input", m, "--mask", "a:b", "--synth", m, "--out",
            str(tmp_path)]]
    for args in bad:
        for main in (predict_asr.main, jcli.main):
            with pytest.raises(SystemExit):
                main(args)
    if not torch.cuda.is_available():
        # --donor's stack runs on the card unless the CPU is asked for
        s = stack["dir"]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            predict_asr.main([
                "--input", m, "--mask", "0.2:0.4", "--donor", m,
                "--config", str(s / "cfg.json"),
                "--codegen-checkpoint", str(s / "g_00000001"),
                "--hubert", str(s / "hubert"), "--kmeans", str(s / "km.npy"),
                "--out", str(tmp_path / "out")])
