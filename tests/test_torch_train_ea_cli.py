"""The port's `train_ea` CLI on the CPU (`--device cpu`), with
`HubertConfig.base` patched to a tiny HuBERT as tests/test_cli_trainers.py
patches the JAX CLI's: it writes `ea_`/`last_`, a rerun resumes from the
newest `ea_`, `--pretrained` reads a local HF directory
(`testing.write_hf_hubert`) into the encoder and `--prenet-only` keeps the
fresh transformer, the JAX CLI writes the same checkpoint names from the
same files, and `predict_ea` reads the trained `last_`: its encoder's
output equals the trained module's (atol 1e-6, f32)."""
import dataclasses
import json

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax

from speech_inpainting_tpu.cli import train_ea as jcli
from speech_inpainting_tpu.models.hubert import HubertConfig as JaxHub
from speech_inpainting_torch import testing
from speech_inpainting_torch.cli import predict_ea, train_ea
from speech_inpainting_torch.convert.from_jax import (hubert_tree,
                                                      trainable_hubert)
from speech_inpainting_torch.models.hifigan import HiFiGANConfig
from speech_inpainting_torch.models.hubert import HubertConfig

HUB = dict(conv_dim=(8,) * 7, hidden_size=32, num_hidden_layers=1,
           num_attention_heads=2, intermediate_size=64,
           num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=2)
GEN = {"resblock": "1", "upsample_rates": [8, 8, 2, 2],
       "upsample_kernel_sizes": [16, 16, 4, 4],
       "upsample_initial_channel": 32, "resblock_kernel_sizes": [3, 7, 11],
       "resblock_dilation_sizes": [[1, 3, 5]] * 3, "num_mels": 80}


class _Tiny:
    """Stands in for a CLI module's HubertConfig: tiny base and large."""

    def __init__(self, cls):
        self.base = lambda **o: dataclasses.replace(cls.base(**HUB), **o)
        self.large = lambda **o: dataclasses.replace(cls.large(**HUB), **o)


@pytest.fixture
def files(tmp_path, monkeypatch, rng):
    monkeypatch.setattr(train_ea, "HubertConfig", _Tiny(HubertConfig))
    monkeypatch.setattr(predict_ea, "HubertConfig", _Tiny(HubertConfig))
    monkeypatch.setattr(JaxHub, "base", staticmethod(
        lambda **o: dataclasses.replace(JaxHub(**HUB), **o)))
    wavs = tmp_path / "wavs16"
    wavs.mkdir()
    frames = (3203 - 80) // 320
    (tmp_path / "labels").mkdir()
    for i in range(4):
        wavfile.write(wavs / f"u{i}.wav", 16000,
                      (testing.synthetic_utterance(rng, 0.2) * 32767
                       ).astype(np.int16))
        np.save(tmp_path / "labels" / f"u{i}_labels.npy",
                rng.integers(0, 10, frames).astype(np.int32))
    (tmp_path / "training.txt").write_text("u0\nu1\nu2\nu3\n")
    (tmp_path / "valid.txt").write_text("u0\nu1\n")
    np.save(tmp_path / "km.npy",
            rng.standard_normal((10, 80)).astype(np.float32))
    cfg = HubertConfig.base(**HUB)
    hub = testing.hubert_model_tree(cfg, rng)
    testing.write_hf_hubert(tmp_path / "hf", hub, cfg)
    return tmp_path, hub


def _args(d, ckpt, *extra):
    return ["--wavs", str(d / "wavs16"), "--split", str(d / "training.txt"),
            "--labels-dir", str(d / "labels"), "--kmeans", str(d / "km.npy"),
            "--checkpoint-path", str(d / ckpt), "--hubert-type", "base",
            "--batch-size", "2", "--mask-length", "3",
            "--max-wav-seconds", "0.2", *extra]


def _names(d):
    return sorted(p.name for p in d.iterdir())


def test_train_ea_cli_writes_and_resumes(files, capsys):
    d, _ = files
    train_ea.main(_args(d, "ckpt", "--epochs", "1", "--device", "cpu",
                        "--valid-split", str(d / "valid.txt")))
    # validation runs every 1000 steps (RunConfig's default): no best_
    assert _names(d / "ckpt") == ["ea_00000002", "last_00000000"]
    state = train_ea.main(_args(d, "ckpt", "--epochs", "1", "--device",
                                "cpu"))
    assert "resumed from step 2" in capsys.readouterr().out
    assert state.step == 4
    assert "ea_00000004" in _names(d / "ckpt")
    # the JAX CLI writes the same names from the same files
    jcli.main(_args(d, "jax", "--epochs", "1", "--valid-split",
                    str(d / "valid.txt")))
    assert _names(d / "jax") == ["ea_00000002", "last_00000000"]


@pytest.mark.parametrize("prenet_only", [False, True])
def test_train_ea_cli_pretrained(files, prenet_only):
    """--epochs 0: `last_` is the model as it was built."""
    d, hub = files
    train_ea.main(_args(d, "ckpt", "--epochs", "0", "--device", "cpu",
                        "--pretrained", str(d / "hf"), "--seed", "5",
                        *(["--prenet-only"] if prenet_only else [])))
    cfg = HubertConfig.base(**HUB)
    model = trainable_hubert(cfg, None, 80, device="cpu")
    model.load_state_dict(torch.load(d / "ckpt" / "last_00000000")["model"])
    got = hubert_tree(model)
    fresh = hubert_tree(trainable_hubert(
        cfg, None, 80, device="cpu",
        generator=torch.Generator().manual_seed(5)))
    for key in hub:
        transformer = key.startswith("layers_") or key in (
            "pos_conv_embed", "encoder_layer_norm")
        want = fresh["hubert"][key] if prenet_only and transformer \
            else hub[key]
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(
                got["hubert"][key])):
            np.testing.assert_array_equal(b, a, err_msg=key)
    for a, b in zip(jax.tree.leaves(fresh["head"]),
                    jax.tree.leaves(got["head"])):
        np.testing.assert_array_equal(b, a)


def test_predict_ea_reads_the_trained_last(files):
    d, _ = files
    state = train_ea.main(_args(d, "ckpt", "--epochs", "1", "--f32",
                                "--device", "cpu"))
    cfg = HubertConfig.base(**HUB)
    loaded = predict_ea.load_trained_hubert(d / "ckpt" / "last_00000000",
                                            cfg, "cpu")
    wav = torch.as_tensor(testing.synthetic_utterance(
        np.random.default_rng(3), 0.5))[None]
    with torch.no_grad():
        np.testing.assert_allclose(loaded(wav).numpy(),
                                   state.model(wav).numpy(), atol=1e-6)
    assert not loaded.hubert.pos_conv_embed.conv.weight.requires_grad
    gcfg = HiFiGANConfig.from_dict(GEN)
    torch.save({"generator": testing.generator_state_dict(
        testing.generator_tree(gcfg, np.random.default_rng(4)), gcfg)},
        d / "g_00000010")
    (d / "config.json").write_text(json.dumps(GEN))
    w22 = testing.synthetic_batch(np.random.default_rng(5), 1, 1.0)[0][0]
    wavfile.write(d / "utt.wav", 22050, (w22 * 32767).astype(np.int16))
    predict_ea.main(["--wav", str(d / "utt.wav"), "--start-sec", "0.3",
                     "--end-sec", "0.5", "--hubert-checkpoint",
                     str(d / "ckpt" / "last_00000000"), "--hubert-type",
                     "base", "--hifigan-checkpoint", str(d / "g_00000010"),
                     "--hifigan-config", str(d / "config.json"), "--kmeans",
                     str(d / "km.npy"), "--out", str(d / "pred"),
                     "--device", "cpu"], figures=False)
    assert _names(d / "pred" / "utt") == [
        "hifi_masked.wav", "inpainted.wav", "masked.wav", "orig.wav"]


def test_train_ea_cli_refuses_the_mesh(files):
    """The flags as the JAX CLI takes them: --mesh trains over the ranks of
    the group it joins (a gloo group of one here: the same two steps);
    --num-processes 2 without a coordinator raises, as initialize does."""
    d, _ = files
    state = train_ea.main(_args(d, "ckpt", "--device", "cpu", "--epochs",
                                "1", "--mesh"))
    assert state.mesh is not None and state.step == 2
    assert not torch.distributed.is_initialized()
    assert _names(d / "ckpt") == ["ea_00000002", "last_00000000"]
    with pytest.raises(ValueError, match="coordinator_address"):
        train_ea.main(_args(d, "ckpt2", "--device", "cpu",
                            "--num-processes", "2"))
