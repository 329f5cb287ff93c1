"""The port's AOT serving artifacts (infer/aot.py) on the CPU, at
tests/test_aot.py's tiny geometries, with the same numpy trees handed to
the port and to the JAX package:

- one batch-polymorphic artifact, exported and reloaded, against the
  port's live `InformedInpainter.batch` at B = 2 and 5 (waveform atol
  1e-5, labels equal: both run the same `InpaintGraph`) and against JAX's
  live graph at tests/test_torch_inpaint.py:test_slice_matches_jax's
  tolerance (atol 1e-4 on the mels and the waveform, labels equal where
  the nearest centroid clears the runner-up by 1e-4), for V1 and for the
  iSTFT-engine override; the exported program holds K1 as the operator
  `si.resblock1`;
- a static `batch=3` artifact behind a plain `Generator` override (K2 as
  `si.resblock_step`): exactly {graph.pt2, meta.json}, loaded and run in a
  process that cannot import the port's models, converters or live
  inpainter, equal to the live batch, B = 2 refused there with "exported
  for batch 3"; a TPU platform refused."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from speech_inpainting_tpu.infer import inpaint as jinp
from speech_inpainting_tpu.models.hifigan import HiFiGANConfig as JaxGen
from speech_inpainting_tpu.models.hifigan_istft import \
    ISTFTGenerator as JaxISTFT
from speech_inpainting_tpu.models.hifigan_istft import \
    ISTFTGeneratorConfig as JaxISTFTConfig
from speech_inpainting_tpu.models.hubert import HubertConfig as JaxHub
from speech_inpainting_torch import testing
from speech_inpainting_torch.convert.from_jax import (
    generator_from_jax, istft_generator_from_jax)
from speech_inpainting_torch.infer import inpaint
from speech_inpainting_torch.infer.aot import (
    export_serving_graph, load_serving_artifact, save_serving_artifact)
from speech_inpainting_torch.models.hifigan import Generator, HiFiGANConfig
from speech_inpainting_torch.models.hifigan_istft import ISTFTGeneratorConfig
from speech_inpainting_torch.models.hubert import HubertConfig

ROOT = Path(__file__).resolve().parents[1]
# tests/test_aot.py's tiny_inpainter and tiny_istft_inpainter
HUB = dict(conv_dim=(8,) * 7, hidden_size=16, num_hidden_layers=1,
           num_attention_heads=2, intermediate_size=24,
           num_conv_pos_embeddings=15, num_conv_pos_embedding_groups=1)
GEN = dict(upsample_rates=(8, 8, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4),
           upsample_initial_channel=16, resblock_kernel_sizes=(3,),
           resblock_dilation_sizes=((1, 3),))
ISTFT = dict(upsample_rates=(8, 8), upsample_kernel_sizes=(16, 16),
             upsample_initial_channel=16, resblock_kernel_sizes=(3,),
             resblock_dilation_sizes=((1, 3),))
T22, T16 = 22050, 16000


def _inputs(rng, B):
    """tests/test_aot.py's `_inputs`: 1 s of N(0, 0.01) noise, masks of 4
    frames at seeded positions."""
    wav22 = (rng.standard_normal((B, T22)) * 0.1).astype(np.float32)
    wav16 = (rng.standard_normal((B, T16)) * 0.1).astype(np.float32)
    pos = rng.integers(0, 30, B)
    return wav22, wav16, pos, np.full(B, 4, np.int64)


def _pair(kind, rng):
    """(port inpainter on the CPU, JAX inpainter) of one numpy tree set."""
    hp = testing.hubert_tree(HubertConfig.base(**HUB), 80, rng)
    centroids = rng.standard_normal((7, 80)).astype(np.float32)
    cfg = inpaint.InpainterConfig(HubertConfig.base(**HUB),
                                  HiFiGANConfig(**GEN))
    jcfg = jinp.InpainterConfig(JaxHub.base(**HUB), JaxGen(**GEN))
    if kind == "v1":
        gp = testing.generator_tree(HiFiGANConfig(**GEN), rng)
        return (inpaint.InformedInpainter(cfg, hp, gp, centroids,
                                          device="cpu"),
                jinp.InformedInpainter(jcfg, hp, gp, centroids))
    tree = testing.generator_tree(ISTFTGeneratorConfig(**ISTFT), rng)
    port = inpaint.InformedInpainter(
        cfg, hp, None, centroids, device="cpu",
        generator=istft_generator_from_jax(ISTFTGeneratorConfig(**ISTFT),
                                           tree, device="cpu"))
    ref = jinp.InformedInpainter(jcfg, hp, tree, centroids,
                                 generator=JaxISTFT(JaxISTFTConfig(**ISTFT)))
    return port, ref


def _targets(art) -> set:
    return {str(n.target) for n in art._program.graph.nodes
            if str(n.target).startswith("si.")}


@pytest.mark.parametrize("kind", ["v1", "istft"])
def test_polymorphic_artifact_matches_live_graphs(kind, tmp_path):
    rng = np.random.default_rng(0)
    port, ref = _pair(kind, rng)
    meta = save_serving_artifact(tmp_path / "art", port, T22, T16,
                                 device="cpu")
    assert meta["poly"] and meta["batch"] is None, meta
    assert meta["platforms"] == ["cpu"]
    art = load_serving_artifact(tmp_path / "art", device="cpu")
    assert art.meta == meta
    assert _targets(art) == {"si.resblock1.default"}
    batches = [_inputs(rng, B) for B in (2, 5)]
    got = [art.batch(*x) for x in batches]
    for x, out in zip(batches, got):
        live = port.batch(*x)
        assert set(out) == set(live)
        for k in live:
            assert out[k].shape == live[k].shape, k
        np.testing.assert_allclose(out["inpainted"].numpy(),
                                   live["inpainted"].numpy(), atol=1e-5)
        assert torch.equal(out["pred_labels"], live["pred_labels"])
    # JAX's live graph once, on both batches' rows (its rows are
    # independent of each other)
    w22, w16, pos, lens = (np.concatenate(a) for a in zip(*batches))
    want = ref.batch(w22, w16, pos.astype(np.int32), lens.astype(np.int32))
    got = {k: torch.cat([out[k] for out in got]).numpy() for k in got[0]}
    for k in ("mel_masked", "mel_inpainted", "inpainted"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-4,
                                   err_msg=k)
    # labels where the nearest centroid is clear of the runner-up
    emb = port.hubert(inpaint.meanvar_normalize(inpaint.mask_wave_frames(
        torch.tensor(w16), torch.tensor(pos), torch.tensor(lens))))
    sim = torch.sort((emb / emb.norm(dim=-1, keepdim=True))
                     @ port.graph.cn.t(), dim=-1).values.numpy()
    clear = sim[..., -1] - sim[..., -2] > 1e-4
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got["pred_labels"][clear],
                                  np.asarray(want["pred_labels"])[clear])


_CHILD = """
import sys
import numpy as np
for name in ("jax", "speech_inpainting_tpu", "speech_inpainting_torch.models",
             "speech_inpainting_torch.convert",
             "speech_inpainting_torch.infer.inpaint"):
    sys.modules[name] = None
from speech_inpainting_torch.infer.aot import load_serving_artifact
art = load_serving_artifact(sys.argv[1], device="cpu")
x = np.load(sys.argv[2])
out = art.batch(x["wav22"], x["wav16"], x["pos"], x["lens"])
try:
    art.batch(x["wav22"][:2], x["wav16"][:2], x["pos"][:2], x["lens"][:2])
except ValueError as e:
    print(e)
print(sorted({str(n.target) for n in art._program.graph.nodes
              if str(n.target).startswith("si.")}))
np.savez(sys.argv[3], **{k: v.numpy() for k, v in out.items()})
"""


def test_static_artifact_is_self_contained(tmp_path):
    rng = np.random.default_rng(1)
    hp = testing.hubert_tree(HubertConfig.base(**HUB), 80, rng)
    gp = testing.generator_tree(HiFiGANConfig(**GEN), rng)
    centroids = rng.standard_normal((7, 80)).astype(np.float32)
    port = inpaint.InformedInpainter(
        inpaint.InpainterConfig(HubertConfig.base(**HUB),
                                HiFiGANConfig(**GEN)),
        hp, None, centroids, device="cpu",
        generator=generator_from_jax(HiFiGANConfig(**GEN), gp, device="cpu",
                                     cls=Generator))
    with pytest.raises(ValueError, match="not \\['tpu'\\]"):
        export_serving_graph(port, T22, T16, platforms=["tpu"], device="cpu")
    meta = save_serving_artifact(tmp_path / "art", port, T22, T16, batch=3,
                                 device="cpu")
    assert {p.name for p in (tmp_path / "art").iterdir()} == {
        "graph.pt2", "meta.json"}
    assert meta == json.loads((tmp_path / "art" / "meta.json").read_text())
    assert meta["batch"] == 3 and not meta["poly"]
    w22, w16, pos, lens = _inputs(rng, 3)
    np.savez(tmp_path / "in.npz", wav22=w22, wav16=w16, pos=pos, lens=lens)
    res = subprocess.run(
        [sys.executable, "-c", _CHILD, str(tmp_path / "art"),
         str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.splitlines() == [
        "artifact exported for batch 3, got 2",
        "['si.resblock_step.default']"], res.stdout
    got = np.load(tmp_path / "out.npz")
    live = port.batch(w22, w16, pos, lens)
    assert set(got.files) == set(live)
    np.testing.assert_allclose(got["inpainted"], live["inpainted"].numpy(),
                               atol=1e-5)
    np.testing.assert_array_equal(got["pred_labels"],
                                  live["pred_labels"].numpy())
