"""The port's I_da CLIs (`inpaint_da`, `vocode codes`) on a temporary
directory of reference-layout checkpoints (a CodeGenerator `g_*` file, a
local HF HuBERT directory, a .npy codebook, a JSON-lines manifest), against
the JAX package's converters (`convert_code_generator`,
`convert_hf_hubert`) and its `IdaInpainter` / `CodeGenerator` on the same
state dicts, on the CPU in float32 at tests/test_torch_ida.py's small sizes.

The JAX `inpaint_da` CLI itself needs `transformers` to read the HuBERT
checkpoint, so the JAX side is assembled from its parts here. The port
writes int16 wavs: they must lie within the I_da waveform tolerance (atol
1e-4, 3.3 int16 steps) plus one step of rounding of JAX's outputs written
the same way; units must agree exactly.
"""
import json

import numpy as np
import torch
from scipy.io import wavfile

import jax.numpy as jnp

from speech_inpainting_tpu.convert import hubert_torch as jhub
from speech_inpainting_tpu.convert import ida_torch as jida
from speech_inpainting_tpu.data.code_dataset import (
    mel_stats_embedder as jax_embedder)
from speech_inpainting_tpu.infer.ida_inpaint import IdaInpainter as JaxIda
from speech_inpainting_tpu.models import codegen as jcodegen
from speech_inpainting_tpu.models.hubert import HubertConfig as JaxHub
from speech_inpainting_torch import testing
from speech_inpainting_torch.cli import inpaint_da, vocode
from speech_inpainting_torch.convert.from_jax import hubert_model_from_jax
from speech_inpainting_torch.data.audio import save_wav
from speech_inpainting_torch.data.code_dataset import mel_stats_embedder
from speech_inpainting_torch.data.manifests import write_manifest
from speech_inpainting_torch.models import codegen
from speech_inpainting_torch.models.hubert import HubertConfig
from test_torch_codegen_vq import CONTENT_VQ
from test_torch_ida import GEN, HUB, STACK

STEPS = 4        # int16 steps: atol 1e-4 · 32767, plus one of rounding
# tests/test_torch_ida.py's CodeGenerator as the reference's config JSON
IDA = {"resblock": "1", "upsample_rates": GEN["upsample_rates"],
       "upsample_kernel_sizes": GEN["upsample_kernel_sizes"],
       "upsample_initial_channel": GEN["upsample_initial_channel"],
       "resblock_kernel_sizes": GEN["resblock_kernel_sizes"],
       "resblock_dilation_sizes": GEN["resblock_dilation_sizes"],
       "num_embeddings": 10, "embedding_dim": 16, "model_in_dim": 48,
       "code_hop_size": 320, "multispkr": "_", "f0_stats": "f0_stats.json",
       "f0_quantizer": {"f0_vq_params": {"l_bins": 6, "emb_width": 16},
                        "f0_encoder_params": STACK,
                        "f0_decoder_params": STACK},
       "sampling_rate": 16000}


def _write_wav(path, wav, sr=16000):
    wavfile.write(path, sr, (wav * 32767).astype(np.int16))


def _read(path) -> np.ndarray:
    return wavfile.read(path)[1]


def test_inpaint_da_cli_matches_jax(rng, tmp_path):
    cfg = codegen.CodeGeneratorConfig.from_dict(IDA)
    jcfg = jcodegen.CodeGeneratorConfig.from_dict(IDA)
    params, vq = testing.codegen_tree(cfg, rng)
    params["fo_vqvae"]["decoder"] = testing.jukebox_tree(
        cfg.f0_quantizer.decoder, rng, decoder=True)
    sd = testing.code_generator_state_dict(params, vq, cfg)
    torch.save({"generator": sd}, tmp_path / "g_00000001")
    hcfg = HubertConfig(**HUB)
    hp = testing.hubert_model_tree(hcfg, rng)
    testing.write_hf_hubert(tmp_path / "hubert", hp, hcfg)
    # one utterance through the wav file's int16 rounding, as both sides
    # read it
    _write_wav(tmp_path / "utt.wav", testing.synthetic_utterance(rng, 3.2))
    audio = _read(tmp_path / "utt.wav").astype(np.float32) / 32768.0
    # centroids at layer-1 features of the clean and masked utterance, so
    # that each frame has a clear nearest unit
    hub = hubert_model_from_jax(hcfg, hp, device="cpu")
    with torch.no_grad():
        feats = [hub(torch.tensor(a)[None], tap_layer=1)[0].numpy()
                 for a in (audio, np.where(
                     (np.arange(audio.size) >= 24000)
                     & (np.arange(audio.size) < 27200), 0, audio + 1e-6))]
    pool = np.concatenate(feats)
    centroids = pool[rng.choice(len(pool), 10, replace=False)]
    np.save(tmp_path / "km.npy", centroids)
    write_manifest(tmp_path / "val.jsonl", [
        {"audio": str(tmp_path / "utt.wav"), "hubert": "1 2 3",
         "duration": 3.2}])
    (tmp_path / "cfg.json").write_text(json.dumps(IDA))

    rtfs = inpaint_da.main([
        "--config", str(tmp_path / "cfg.json"),
        "--manifest", str(tmp_path / "val.jsonl"),
        "--codegen-checkpoint", str(tmp_path / "g_00000001"),
        "--hubert", str(tmp_path / "hubert"), "--layer", "1",
        "--kmeans", str(tmp_path / "km.npy"), "--mask-ms", "100", "200",
        "--out", str(tmp_path / "out"), "--device", "cpu"])
    assert len(rtfs) == 2 and min(rtfs) > 0
    written = sorted(p.name for p in (tmp_path / "out").iterdir())
    assert written == sorted(f"utt_{s}.wav" for s in (
        "gt", "gen", "masked_100", "inpainted_100", "masked_200",
        "inpainted_200"))

    # the JAX side: its converters on the same state dicts, its embedder
    jp, jvq = jida.convert_code_generator(sd, jcfg)
    jhp = jhub.convert_hf_hubert(testing.hubert_state_dict(hp, hcfg),
                                 JaxHub(**HUB))
    emb = jax_embedder(16)(audio, 16000)
    np.testing.assert_allclose(mel_stats_embedder(16, device="cpu")(
        audio, 16000), emb, atol=1e-6)
    ref = JaxIda(jcfg, jp, jvq, JaxHub(**HUB), jhp, centroids, tap_layer=1,
                 code_hop=320)
    d = np.sort(np.asarray(jnp.sum(
        (pool[:, None] - centroids[None]) ** 2, -1)), axis=-1)[:, :2]
    assert (d[:, 1] - d[:, 0]).min() > 1e-3      # units far from a tie
    for ms in (100, 200):
        want = ref(audio, mask_size=ms * 16, emb=emb)
        names = {f"masked_{ms}": "audio_mask",
                 f"inpainted_{ms}": "audio_inpainted"}
        if ms == 100:
            names.update(gt="audio_gt", gen="audio_gen")
        for suffix, key in names.items():
            save_wav(tmp_path / "want.wav", np.asarray(want[key]), 16000)
            w, g = _read(tmp_path / "want.wav"), _read(
                tmp_path / "out" / f"utt_{suffix}.wav")
            assert g.shape == w.shape and g.shape[0] % 1280 == 0, suffix
            assert np.abs(g.astype(np.int32) - w).max() <= STEPS, suffix
    gen, inp = (_read(tmp_path / "out" / f"utt_{s}.wav").astype(np.int32)
                for s in ("gen", "inpainted_200"))
    assert np.abs(gen - inp).max() > 100 * STEPS   # the mask moved units


def test_vocode_codes_cli_matches_jax(rng, tmp_path):
    cfg = codegen.CodeGeneratorConfig.from_dict(CONTENT_VQ)
    jcfg = jcodegen.CodeGeneratorConfig.from_dict(CONTENT_VQ)
    params, vq = testing.codegen_tree(cfg, rng)
    sd = testing.code_generator_state_dict(params, vq, cfg)
    assert "code_vq.level_blocks.0.k" in sd and "emb_c.weight" not in sd
    torch.save({"generator": sd}, tmp_path / "g_00000001")
    (tmp_path / "cfg.json").write_text(json.dumps(CONTENT_VQ))
    paths = []
    for name, n in (("a", 1600), ("b", 2400)):
        _write_wav(tmp_path / f"{name}.wav",
                   0.5 * testing.synthetic_utterance(rng, n / 16000))
        paths.append(str(tmp_path / f"{name}.wav"))
    (tmp_path / "list.txt").write_text("\n".join(paths) + "\n")
    vocode.main(["codes", "--config", str(tmp_path / "cfg.json"),
                 "--checkpoint", str(tmp_path / "g_00000001"),
                 "--manifest", str(tmp_path / "list.txt"), "--out",
                 str(tmp_path / "codes.txt"), "--device", "cpu"])
    lines = (tmp_path / "codes.txt").read_text().splitlines()
    jp, jvq = jida.convert_code_generator(sd, jcfg)
    m = jcodegen.CodeGenerator(jcfg)
    for line, p in zip(lines, paths):
        stem, units = line.split("|")
        wav = _read(p).astype(np.float32) / 32768.0
        want = m.apply({"params": jp, "vq": jvq}, jnp.asarray(wav)[None, None],
                       method=m.encode_codes)[0]
        assert stem == p.rsplit("/", 1)[1][:-4]
        assert [int(u) for u in units.split(",")] == np.asarray(want).tolist()
        assert len(want) == len(wav) // 4
