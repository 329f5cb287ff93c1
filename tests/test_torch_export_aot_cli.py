"""The port's `export_aot` CLI on the CPU (`--device cpu`), on files the
test writes: a HuBERT-base `CustomModel` state dict (.pt), a narrow V1
`g_*` file with its config json and a .npy codebook; the CLI's HuBERT
config is patched to a tiny base one (two layers, hidden 64), as
tests/test_torch_cli.py patches it. Its batch-polymorphic artifact reloads
and gives the same outputs as a direct `export_serving_graph` of the same
inpainter, at B = 1 and 3 (atol 1e-6, labels equal), and as the live
inpainter; `--platforms tpu` is refused. (`--batch` goes to the same
`save_serving_artifact(batch=...)` that tests/test_torch_aot.py holds.)"""
import argparse
import json

import numpy as np
import pytest
import torch

from speech_inpainting_torch import testing
from speech_inpainting_torch.cli import export_aot, predict_ea
from speech_inpainting_torch.infer.aot import (export_serving_graph,
                                               load_serving_artifact)
from speech_inpainting_torch.models.hifigan import HiFiGANConfig
from speech_inpainting_torch.models.hubert import HubertConfig

HUB = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=128, conv_dim=(32,) * 7,
           num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
GEN = {"resblock": "1", "upsample_rates": [8, 8, 2, 2],
       "upsample_kernel_sizes": [16, 16, 4, 4],
       "upsample_initial_channel": 32, "resblock_kernel_sizes": [3, 7],
       "resblock_dilation_sizes": [[1, 3, 5]] * 2, "num_mels": 80}
SECONDS = 1.0


class _Tiny:
    """Stands in for predict_ea's HubertConfig: `base()` at tiny widths."""
    base = staticmethod(lambda: HubertConfig.base(**HUB))
    large = staticmethod(lambda: HubertConfig.large(**HUB))


@pytest.fixture
def files(tmp_path, monkeypatch):
    monkeypatch.setattr(predict_ea, "HubertConfig", _Tiny)
    rng = np.random.default_rng(0)
    cfg = HubertConfig.base(**HUB)
    torch.save(testing.custom_model_state_dict(
        testing.hubert_tree(cfg, 80, rng), cfg), tmp_path / "best.pt")
    gcfg = HiFiGANConfig.from_dict(GEN)
    torch.save({"generator": testing.generator_state_dict(
        testing.generator_tree(gcfg, rng, carry=True), gcfg)},
        tmp_path / "g_00000010")
    (tmp_path / "config.json").write_text(json.dumps(GEN))
    np.save(tmp_path / "km.npy",
            rng.standard_normal((7, 80)).astype(np.float32))
    return tmp_path


def _args(d, out, *extra):
    return ["--seconds", str(SECONDS), "--hubert-checkpoint",
            str(d / "best.pt"), "--hubert-type", "base",
            "--hifigan-checkpoint", str(d / "g_00000010"),
            "--hifigan-config", str(d / "config.json"), "--kmeans",
            str(d / "km.npy"), "--out", str(d / out), "--device", "cpu",
            *extra]


def test_export_aot_cli_matches_a_direct_export(files, capsys):
    d = files
    with pytest.raises(SystemExit):
        export_aot.main(_args(d, "tpu", "--platforms", "tpu"))
    assert "--platforms tpu" in capsys.readouterr().err
    meta = export_aot.main(_args(d, "cli"))
    assert meta["poly"] and meta["platforms"] == ["cpu"]
    assert "batch-polymorphic" in capsys.readouterr().out
    ns = argparse.Namespace(**{k.replace("-", "_"): v for k, v in (
        ("kmeans", str(d / "km.npy")), ("hubert-type", "base"),
        ("hifigan-config", str(d / "config.json")), ("device", "cpu"),
        ("hubert-checkpoint", str(d / "best.pt")),
        ("hifigan-checkpoint", str(d / "g_00000010")))})
    inp = predict_ea.load_inpainter(ns)
    t22, t16 = int(SECONDS * 22050), int(SECONDS * 16000)
    ep, direct_meta = export_serving_graph(inp, t22, t16, device="cpu")
    assert direct_meta == meta
    direct = ep.module()
    cli = load_serving_artifact(d / "cli", device="cpu")
    rng = np.random.default_rng(1)
    for B in (1, 3):
        w22, w16, pos, lens = testing.synthetic_batch(rng, B, SECONDS,
                                                      mask_frames=5)
        got = cli.batch(w22, w16, pos, lens)
        with torch.inference_mode():
            want = direct(*(torch.as_tensor(a) for a in (w22, w16, pos,
                                                         lens)))
        live = inp.batch(w22, w16, pos, lens)
        for ref in (want, live):
            np.testing.assert_allclose(got["inpainted"].numpy(),
                                       ref["inpainted"].numpy(), atol=1e-6)
            assert torch.equal(got["pred_labels"], ref["pred_labels"])
