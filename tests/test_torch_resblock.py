"""The fused ResBlock1 wrappers and plain versions (speech_inpainting_torch.
ops.resblock) against the TPU kernels in interpret mode and the unfused JAX
chain, on the CPU in float32, at tests/test_pallas.py's shapes and
tolerances: atol 3e-5 for a whole block (K1), 2e-5 for one step (K2) and for
`resblock1_forward`'s chain of steps. The CUDA kernel itself runs only on
the card: chip_smoke.py holds it against the plain versions there. Its
launch plan is Python and is checked here at every shape either path and
chip_smoke.py give it."""
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_inpainting_tpu.ops.conv import conv1d, get_padding
from speech_inpainting_tpu.ops.pallas_resblock import fused_resblock1 as tpu_k1
from speech_inpainting_tpu.ops.pallas_resblock import \
    fused_resblock_step as tpu_k2
from speech_inpainting_tpu.ops.pallas_resblock import \
    resblock1_forward as tpu_resblock1_forward
from speech_inpainting_torch.ops import resblock
from speech_inpainting_torch.ops.conv import weight_norm_kernel


def _unfused_jax(x, w1, b1, w2, b2, dilations, K):
    for s, d in enumerate(dilations):
        h = jax.nn.leaky_relu(x, 0.1)
        h = conv1d(h, w1[s], b1[s], dilation=d, padding=get_padding(K, d),
                   precision="highest")
        h = jax.nn.leaky_relu(h, 0.1)
        h = conv1d(h, w2[s], b2[s], dilation=1, padding=get_padding(K, 1),
                   precision="highest")
        x = x + h
    return x


def _inputs(rng, B, C, T, K, S=3):
    return (rng.standard_normal((B, C, T)).astype(np.float32),
            rng.standard_normal((S, C, C, K)).astype(np.float32) * 0.05,
            rng.standard_normal((S, C)).astype(np.float32) * 0.1,
            rng.standard_normal((S, C, C, K)).astype(np.float32) * 0.05,
            rng.standard_normal((S, C)).astype(np.float32) * 0.1)


@pytest.mark.parametrize("B,C,T,K", [(2, 32, 300, 3), (1, 16, 257, 11)])
def test_resblock1_matches_tpu_kernel_and_chain(rng, B, C, T, K):
    dils = (1, 3, 5)
    arrs = _inputs(rng, B, C, T, K)
    j = [jnp.asarray(a) for a in arrs]
    want_chain = np.asarray(_unfused_jax(*j, dils, K))
    want_k1 = np.asarray(tpu_k1(*j, dilations=dils, tile=128,
                                interpret=True))
    t = [torch.tensor(a) for a in arrs]
    plain = resblock.resblock1_reference(*t, dils).numpy()
    np.testing.assert_allclose(plain, want_chain, atol=3e-5)
    np.testing.assert_allclose(plain, want_k1, atol=3e-5)
    # on a CPU tensor the wrapper is the plain version, and counts nothing
    before = resblock.fused_resblock1.launches
    np.testing.assert_array_equal(
        resblock.fused_resblock1(*t, dils).numpy(), plain)
    assert resblock.fused_resblock1.launches == before


# test_pallas.py's K2 cases: (weight scale, biases) as there
@pytest.mark.parametrize("B,C,T,K,D,scale,bias", [
    (2, 32, 300, 3, 5, 0.1, True), (1, 16, 257, 11, 3, 0.05, False)])
def test_resblock_step_matches_tpu_kernel(rng, B, C, T, K, D, scale, bias):
    def normal(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    b_std = 0.1 if bias else 0.0
    arrs = (normal((B, C, T), 1.0), normal((C, C, K), scale),
            normal(C, b_std), normal((C, C, K), scale), normal(C, b_std))
    want = np.asarray(tpu_k2(*(jnp.asarray(a) for a in arrs), dilation=D,
                             tile=128, interpret=True))
    t = [torch.tensor(a) for a in arrs]
    plain = resblock.resblock_step_reference(*t, D).numpy()
    np.testing.assert_allclose(plain, want, atol=2e-5)
    before = resblock.fused_resblock_step.launches
    np.testing.assert_array_equal(
        resblock.fused_resblock_step(*t, D).numpy(), plain)
    assert resblock.fused_resblock_step.launches == before


@pytest.mark.parametrize("B,C,T,K", [(2, 32, 300, 3), (1, 16, 257, 11)])
def test_resblock1_forward_matches_jax(rng, B, C, T, K):
    """The flax ResBlock1 tree, folded by JAX on every call and by the port
    once, through JAX's chain of K2 calls and the port's."""
    dils = (1, 3, 5)
    x = rng.standard_normal((B, C, T)).astype(np.float32)
    tree = {f"convs{n}_{s}": {
        "v": rng.standard_normal((C, C, K)).astype(np.float32),
        "g": rng.uniform(0.1, 0.4, C).astype(np.float32),
        "b": rng.standard_normal(C).astype(np.float32) * 0.1}
        for n in (1, 2) for s in range(len(dils))}
    want = np.asarray(tpu_resblock1_forward(
        jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, tree), K, dils,
        tile=128, interpret=True))
    block = {}
    for n in ("1", "2"):
        convs = [tree[f"convs{n}_{s}"] for s in range(len(dils))]
        block["w" + n] = torch.stack([weight_norm_kernel(
            torch.tensor(c["v"]), torch.tensor(c["g"])) for c in convs])
        block["b" + n] = torch.stack([torch.tensor(c["b"]) for c in convs])
    got = resblock.resblock1_forward(torch.tensor(x), block, dils).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_check_refuses_weights_the_kernel_cannot_copy(rng):
    """The kernel copies weight rows in 16-byte pieces: a contiguous weight
    tensor that starts off a 16-byte boundary is refused, not misread."""
    x, w, b, _, _ = (torch.tensor(a) for a in _inputs(rng, 1, 16, 32, 3, 1))
    shifted = torch.empty(w.numel() + 1)[1:].view(w.shape[1:])
    shifted.copy_(w[0])
    args = (x, w[0], b[0], w[0], b[0], (16, 16, 3), (16,), 3)
    resblock._check("f", *args)
    with pytest.raises(ValueError, match="16-byte aligned"):
        resblock._check("f", x, shifted, *args[2:])


def test_wrapper_refuses_devices_without_a_kernel(rng):
    t = [torch.tensor(a, device="meta") for a in _inputs(rng, 1, 8, 16, 3)]
    with pytest.raises(ValueError, match="no kernel"):
        resblock.fused_resblock1(*t, (1, 3, 5))
    with pytest.raises(ValueError, match="no kernel"):
        resblock.fused_resblock_step(t[0], t[1][0], t[2][0], t[3][0],
                                     t[4][0], 3)


ROOT = Path(__file__).resolve().parents[1]


def _stages(config, frames, B):
    """(B, C, T, K, d) of every residual step of a generator config, with
    `frames` input frames."""
    with open(ROOT / "configs" / config) as f:
        h = json.load(f)
    T = frames
    for i, u in enumerate(h["upsample_rates"]):
        T *= u
        C = h["upsample_initial_channel"] // 2 ** (i + 1)
        for K, dils in zip(h["resblock_kernel_sizes"],
                           h["resblock_dilation_sizes"]):
            for d in dils:
                yield B, C, T, K, d


PLAN_SHAPES = {
    # I_ea: V1 at B = 4 × 4 s, 344 mel frames of hop 256
    "I_ea": list(_stages("hifigan_v1.json", 344, 4)),
    # the long-form windows (4 s, batch 8) and the serving batches of
    # chip_smoke.py (B = 64, and bench.py's 256), through V1; the iSTFT
    # engine's trunk is V1's first two stages, at I_ea's shapes
    "longform": list(_stages("hifigan_v1.json", 344, 8)),
    "serving_64": list(_stages("hifigan_v1.json", 344, 64)),
    "serving_256": list(_stages("hifigan_v1.json", 344, 256)),
    # I_da: the unit vocoder at B = 1, 196 code frames (a 4 s utterance)
    "I_da": list(_stages("da_hubert100_lut.json", 196, 1)),
    # chip_smoke.py's K1 check: V1's 12 (C, K) shapes at B = 2, T = 2049
    "check": [(2, C, 2049, K, d) for C in (256, 128, 64, 32)
              for K in (3, 7, 11) for d in (1, 3, 5)],
    # chip_smoke.py's edge shapes: T shorter than one time tile, T not a
    # multiple of 8, B = 3, and C = 16 with K = 11, d = 5
    "edge": [(1, C, T, K, d) for C in (256, 16) for T in (5, 37)
             for K, d in ((3, 1), (11, 5))]
    + [(3, C, 1001, K, d) for C in (128, 32, 16)
       for K, d in ((7, 3), (11, 5))],
}


@pytest.mark.parametrize("path", sorted(PLAN_SHAPES))
def test_launch_plan_covers_every_shape(path):
    for B, C, T, K, d in PLAN_SHAPES[path]:
        plan = resblock._plan(B, C, T, K, d)
        # channel tiles cover C, time tiles cover T exactly
        assert C % plan.co_tile == 0, (path, C, plan)
        n_t = math.ceil(T / plan.t_tile)
        assert (n_t - 1) * plan.t_tile < T <= n_t * plan.t_tile
        assert plan.blocks == B * (C // plan.co_tile) * n_t
        assert max(plan.smem_a, plan.smem_b) <= 232448
        assert plan.smem_a == resblock._smem(plan.co_tile, plan.t_tile, K, d)
        assert plan.smem_b == resblock._smem(plan.co_tile, plan.t_tile, K, 1)
        # one block per SM wherever B·C·T has that much work for some tile
        most = max(B * (C // co) * math.ceil(T / tt)
                   for co, tt, _ in resblock.TILES if C % co == 0)
        assert plan.blocks >= min(132, most), (path, B, C, T, K, d, plan)
        # the plan the wrapper hands the kernel: 6 ints for the step
        assert list(resblock._plan_array(B, C, T, K, (d,))) == [
            plan.co_tile, plan.t_tile, plan.smem_a,
            plan.co_tile, plan.t_tile, plan.smem_b]


@pytest.mark.parametrize("C,K,d", [(24, 3, 1), (16, 4, 1), (16, 3, 0),
                                   (16, 11, 7), (16, 5, 1), (16, 13, 1)])
def test_launch_plan_refuses_what_the_kernel_does_not_take(C, K, d):
    with pytest.raises(ValueError):
        resblock._plan(1, C, 100, K, d)
