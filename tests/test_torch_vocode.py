"""The port's `vocode` CLI (wav2wav, mel2wav, --quantize-mel) against the
flax Generator, JAX's mel frontend and JAX's
`replace_mel_span_with_centroids`, on the CPU in float32, for V1 and V3
(ResBlock2) at width 32, from reference-layout `g_*` files.

The port writes int16 wavs; the expected ones are the flax outputs written
the same way. Tolerance: the generator tests' atol 1e-4 on the waveform,
i.e. 3.3 int16 steps, plus one step of rounding: 4 steps. The quantized
span's frames must get JAX's centroids exactly (the codebook rows are mel
frames of the input plus noise, far from a tie).
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from speech_inpainting_tpu.cli.vocode import (
    replace_mel_span_with_centroids as jax_replace)
from speech_inpainting_tpu.models.hifigan import Generator
from speech_inpainting_tpu.models.hifigan import HiFiGANConfig as JaxGen
from speech_inpainting_tpu.ops import mel as jmel
from speech_inpainting_tpu.quantize.kmeans import KMeans as JaxKMeans
from speech_inpainting_torch import testing
from speech_inpainting_torch.cli import vocode
from speech_inpainting_torch.data.audio import load_wav, peak_normalize
from speech_inpainting_torch.data.audio import save_wav
from speech_inpainting_torch.models.hifigan import HiFiGANConfig
from speech_inpainting_torch.quantize.kmeans import KMeans

ROOT = Path(__file__).resolve().parents[1]
STEPS = 4        # int16 steps: atol 1e-4 · 32767, plus one of rounding


def _setup(tmp_path, rng, config):
    h = dict(json.loads((ROOT / "configs" / config).read_text()),
             upsample_initial_channel=32)
    (tmp_path / "cfg.json").write_text(json.dumps(h))
    cfg = HiFiGANConfig.from_dict(h)
    tree = testing.generator_tree(cfg, rng, carry=True)
    torch.save({"generator": testing.generator_state_dict(tree, cfg)},
               tmp_path / "g_00000001")
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    for name in ("u1", "u2"):
        w = testing.synthetic_utterance(rng, 0.5, sr=22050)
        wavfile.write(wavs / f"{name}.wav", 22050,
                      (w * 32767).astype(np.int16))
    fwd = jax.jit(lambda m: Generator(JaxGen.from_dict(h)).apply(
        {"params": tree}, m)[:, 0])
    return fwd, wavs


def _expected(tmp_path, name, wav) -> np.ndarray:
    save_wav(tmp_path / f"{name}.wav", np.asarray(wav)[0], 22050)
    return wavfile.read(tmp_path / f"{name}.wav")[1]


def _steps(path, want) -> int:
    _, got = wavfile.read(path)
    assert got.shape == want.shape
    return int(np.abs(got.astype(np.int32) - want).max())


@pytest.mark.parametrize("config", ["hifigan_v1.json", "hifigan_v3.json"])
def test_vocode_cli_matches_flax(rng, tmp_path, config):
    fwd, wavs = _setup(tmp_path, rng, config)
    common = ["--checkpoint", str(tmp_path / "g_00000001"), "--config",
              str(tmp_path / "cfg.json"), "--device", "cpu"]
    mels = tmp_path / "mels"
    mels.mkdir()
    want, quantized = {}, {}
    frames = []
    for p in sorted(wavs.glob("*.wav")):
        wav = peak_normalize(load_wav(p, target_sr=22050)[0], 0.95)
        mel = jmel.mel_spectrogram(jnp.asarray(wav)[None],
                                   jmel.VOCODER_MEL_22K)
        assert mel.shape == (1, 80, 43)
        np.save(mels / f"{p.stem}.npy", np.asarray(mel)[0])   # 2-D
        want[p.stem] = fwd(mel)
        frames.append(np.asarray(mel)[0].T)
    # the codebook: frames of the inputs, moved off them by noise
    frames = np.concatenate(frames)
    C = (frames[rng.choice(len(frames), 12, replace=False)]
         + 0.05 * rng.standard_normal((12, 80))).astype(np.float32)
    np.save(tmp_path / "km.npy", C)
    for p in sorted(wavs.glob("*.wav")):
        mel = np.load(mels / f"{p.stem}.npy")[None]
        q = jax_replace(jnp.asarray(mel), JaxKMeans(jnp.asarray(C)), 5, 20)
        got_q = vocode.replace_mel_span_with_centroids(
            torch.tensor(mel), KMeans(C), 5, 20).numpy()
        np.testing.assert_array_equal(got_q[..., 5:25], q[..., 5:25])
        assert not np.array_equal(q, mel)
        quantized[p.stem] = fwd(jnp.asarray(q))
    # the port's mel of the same wav feeds the quantized span
    vocode.main(["wav2wav", "--input-dir", str(wavs), "--out",
                 str(tmp_path / "out"), *common])
    vocode.main(["wav2wav", "--input-dir", str(wavs), "--out",
                 str(tmp_path / "out"), "--quantize-mel",
                 str(tmp_path / "km.npy"), "--quantize-span", "5:20",
                 *common])
    vocode.main(["mel2wav", "--input-dir", str(mels), "--out",
                 str(tmp_path / "out"), *common])
    written = sorted(p.name for p in (tmp_path / "out").iterdir())
    assert written == sorted(f"{n}{s}.wav" for n in want for s in (
        "_generated", "_generated_quantized", "_generated_e2e"))
    for name in want:
        w = _expected(tmp_path, f"{name}_want", want[name])
        assert np.abs(w).max() > 1000               # not a silent wave
        assert w.shape == (43 * 256,)
        assert _steps(tmp_path / "out" / f"{name}_generated.wav", w) \
            <= STEPS
        assert _steps(tmp_path / "out" / f"{name}_generated_e2e.wav", w) \
            <= STEPS
        wq = _expected(tmp_path, f"{name}_want_q", quantized[name])
        assert _steps(tmp_path / "out" / f"{name}_generated_quantized.wav",
                      wq) <= STEPS
        assert np.abs(wq.astype(np.int32) - w).max() > 100 * STEPS


def test_vocode_mel2wav_takes_3d_mels_and_refuses_no_card(rng, tmp_path):
    fwd, _ = _setup(tmp_path, rng, "hifigan_v1.json")
    mels = tmp_path / "mels"
    mels.mkdir()
    mel = rng.standard_normal((1, 80, 43)).astype(np.float32) - 4.0
    np.save(mels / "m.npy", mel)
    common = ["--checkpoint", str(tmp_path / "g_00000001"), "--config",
              str(tmp_path / "cfg.json")]
    vocode.main(["mel2wav", "--input-dir", str(mels), "--out",
                 str(tmp_path / "out"), "--device", "cpu", *common])
    w = _expected(tmp_path, "want", fwd(jnp.asarray(mel)))
    assert _steps(tmp_path / "out" / "m_generated_e2e.wav", w) <= STEPS
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            vocode.main(["mel2wav", "--input-dir", str(mels), "--out",
                         str(tmp_path / "out"), *common])
