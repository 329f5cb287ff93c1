"""Inference HiFi-GAN generator whose ResBlock1s run in K1.

Counterpart of speech_inpainting_tpu/models/hifigan_fast.py:FastGenerator:
the generator of models/hifigan.py with every ResBlock1 of the
multi-receptive-field fusion in one `fused_resblock1` call (K1, all of a
block's residual steps) when the generator lies on the card.
"""
from __future__ import annotations

from ..ops.resblock import fused_resblock1, resblock1_reference
from .hifigan import Generator


class FastGenerator(Generator):
    """`Generator` with each ResBlock1 in one K1 call; `use_kernel = False`
    routes them to the plain version."""

    def resblock(self, x, p, dilations):
        fn = fused_resblock1 if self.use_kernel else resblock1_reference
        return fn(x, p["w1"], p["b1"], p["w2"], p["b2"], dilations)
