"""The port's serving layer against the JAX package's, on the CPU.

- `PipelinedRunner`: results in submission order, equal to a per-batch
  loop; at most `depth` batches in flight; depth 1 (as tests/test_serving.py
  holds the JAX runner);
- the long-form helpers (`plan_windows`, `merge_mask_spans`,
  `_crossfade_paste`) against the JAX functions on the same inputs, exactly
  (integer plans; the paste is float64 arithmetic on both sides);
- a tiny `LongFormInpainter` (tiny HuBERT, narrow V1, 0.5 s windows,
  batch 2, depth 2, a 3 s recording with three masks, two of them 2 frames
  apart) against the JAX one on the same weights: atol 1e-4 on the
  waveform, and bit-equal to the input outside the pasted spans;
- `batch_expected` and `hifi_masked` against the JAX inpainter's, float32,
  atol 1e-4 on mels and waveforms (test_torch_inpaint.py's tolerance).
"""
import numpy as np
import pytest
import torch

from speech_inpainting_tpu.infer import inpaint as jinp
from speech_inpainting_tpu.infer import longform as jlf
from speech_inpainting_tpu.models.hifigan import HiFiGANConfig as JaxGen
from speech_inpainting_tpu.models.hubert import HubertConfig as JaxHub
from speech_inpainting_torch import testing
from speech_inpainting_torch.infer import inpaint, longform
from speech_inpainting_torch.infer.serving import (PipelinedRunner, force,
                                                   to_host)
from speech_inpainting_torch.models.hifigan import HiFiGANConfig
from speech_inpainting_torch.models.hubert import HubertConfig

HUB = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=128, conv_dim=(32,) * 7,
           num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
GEN = dict(upsample_initial_channel=32)


def _work(x):
    return {"y": x * 2 + 1, "s": [x.sum()]}


def _batches(n, b=4):
    rng = np.random.default_rng(0)
    return [(torch.tensor(rng.standard_normal((b, 8))),) for _ in range(n)]


@pytest.mark.parametrize("fetch", [None, to_host])
def test_results_match_sync_loop_in_order(fetch):
    batches = _batches(7)
    want = [_work(*a) for a in batches]
    runner = PipelinedRunner(_work, depth=3, fetch=fetch)
    got = list(runner.map(batches))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g["y"], w["y"]) and torch.equal(g["s"][0],
                                                            w["s"][0])
    assert runner.submitted == runner.completed == len(batches)


def test_depth_bounds_inflight():
    runner = PipelinedRunner(_work, depth=2)
    seen = []
    for args in _batches(6):
        n_ready = len(runner.submit(*args))
        seen.append(len(runner._inflight))
        assert len(runner._inflight) <= 2
        assert n_ready in (0, 1)
    assert seen[-1] == 2          # the steady state keeps the pipe full
    assert len(runner.drain()) == 2
    assert runner.submitted == runner.completed == 6


def test_depth_one_is_per_batch_sync():
    runner = PipelinedRunner(_work, depth=1)
    out = list(runner.map(_batches(3)))
    assert len(out) == 3 and runner.throughput(1.0) > 0
    x = torch.ones(3)
    assert force(x) is x and to_host({"a": x})["a"] is x


@pytest.mark.parametrize("total,pos,lens,window,margin", [
    (500, [10, 200, 480], [5, 20, 20], 50, 2),
    (30, [0, 25], [3, 5], 50, 2),          # a recording under one window
    (100, [0, 96], [4, 4], 20, 3)])        # masks at both edges
def test_plan_windows_matches_jax(total, pos, lens, window, margin):
    got = longform.plan_windows(total, pos, lens, window, margin)
    want = jlf.plan_windows(total, pos, lens, window, margin)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        longform.plan_windows(total, pos, [window] * len(pos), window, margin)


@pytest.mark.parametrize("pos,lens", [([300, 10, 100, 112, 118],
                                       [5, 5, 10, 4, 3]),
                                      ([5], [3]), ([0, 3, 6], [3, 1, 9])])
def test_merge_mask_spans_matches_jax(pos, lens):
    got = longform.merge_mask_spans(pos, lens)
    want = jlf.merge_mask_spans(pos, lens)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("start,n,fade,fi,fo", [(100, 300, 40, True, True),
                                                (-20, 100, 30, False, True),
                                                (900, 200, 64, True, False),
                                                (50, 10, 40, True, True)])
def test_crossfade_paste_matches_jax(rng, start, n, fade, fi, fo):
    y = rng.standard_normal(1000).astype(np.float32)
    patch = rng.standard_normal(n)
    got, want = y.copy(), y.copy()
    longform._crossfade_paste(got, patch, start, fade, fade_in=fi,
                              fade_out=fo)
    jlf._crossfade_paste(want, patch, start, fade, fade_in=fi, fade_out=fo)
    np.testing.assert_array_equal(got, want)


def _inpainters(rng):
    hp = testing.hubert_tree(HubertConfig.base(**HUB), 80, rng)
    gp = testing.generator_tree(HiFiGANConfig(**GEN), rng)
    centroids = rng.standard_normal((7, 80)).astype(np.float32)
    ref = jinp.InformedInpainter(
        jinp.InpainterConfig(JaxHub.base(**HUB), JaxGen(**GEN)), hp, gp,
        centroids)
    port = inpaint.InformedInpainter(
        inpaint.InpainterConfig(HubertConfig.base(**HUB),
                                HiFiGANConfig(**GEN)),
        hp, gp, centroids, device="cpu")
    return ref, port


def test_long_form_matches_jax(rng):
    ref, port = _inpainters(rng)
    w22, w16, _, _ = testing.synthetic_batch(rng, 1, 3.0)
    pos, lens = [20, 100, 107], [10, 5, 6]      # 100 and 107: 2 frames apart
    want, want_spans = jlf.LongFormInpainter(ref, jlf.LongFormConfig(
        window_frames=25, batch=2, depth=2))(w22[0], w16[0], pos, lens)
    lf = longform.LongFormInpainter(port, longform.LongFormConfig(
        window_frames=25, batch=2, depth=2))
    got, spans = lf(w22[0], w16[0], pos, lens)
    assert spans == want_spans and len(spans) == 2
    np.testing.assert_allclose(got, want, atol=1e-4)
    outside = np.ones(len(got), bool)
    for a, b in spans:
        outside[a:b] = False
    np.testing.assert_array_equal(got[outside], w22[0][outside])
    assert not np.array_equal(got, w22[0])


def test_batch_expected_and_hifi_masked_match_jax(rng):
    ref, port = _inpainters(rng)
    w22, _, pos, lens = testing.synthetic_batch(rng, 2, 0.5, mask_frames=5)
    labels = rng.integers(0, 7, (2, 25))
    want = ref.batch_expected(w22, labels, pos.astype(np.int32),
                              lens.astype(np.int32))
    got = port.batch_expected(w22, labels, pos, lens)
    for k in ("expected_inpaint", "mel_expected"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-4, err_msg=k)
    one = port.expected_inpaint(w22[1], labels[1], int(pos[1]), int(lens[1]))
    # one utterance is the batch's row, up to the CPU convs' batch-size
    # dependent summation order
    np.testing.assert_allclose(one["expected_inpaint"].numpy(),
                               got["expected_inpaint"][1].numpy(), atol=1e-6)
    want = np.asarray(ref.hifi_masked(w22[0], int(pos[0]), int(lens[0])))
    got = port.hifi_masked(w22[0], int(pos[0]), int(lens[0])).numpy()
    assert got.shape == want.shape == (w22.shape[1] // 441 * 441 // 256
                                       * 256,)
    np.testing.assert_allclose(got, want, atol=1e-4)
