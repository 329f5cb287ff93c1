"""The fused ResBlock1's wrapper and plain version (speech_inpainting_torch.
ops.resblock) against the TPU kernel in interpret mode and the unfused JAX
chain, on the CPU in float32, at tests/test_pallas.py's shapes and tolerance
(atol 3e-5). The CUDA kernel itself runs only on the card: chip_smoke.py
holds it against the plain version there."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_inpainting_tpu.ops.conv import conv1d, get_padding
from speech_inpainting_tpu.ops.pallas_resblock import fused_resblock1 as tpu_k1
from speech_inpainting_torch.ops import resblock


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


def test_wrapper_refuses_devices_without_a_kernel(rng):
    t = [torch.tensor(a, device="meta") for a in _inputs(rng, 1, 8, 16, 3)]
    with pytest.raises(ValueError, match="no kernel"):
        resblock.fused_resblock1(*t, (1, 3, 5))
