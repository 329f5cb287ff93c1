"""Inference HiFi-GAN generator whose ResBlock1s run in K1.

Counterpart of speech_inpainting_tpu/models/hifigan_fast.py:FastGenerator:
the generator of models/hifigan.py with every ResBlock1 of the
multi-receptive-field fusion in one K1 call (all of a block's residual
steps) when the generator lies on the card. The call goes through the
operator `torch.ops.si.resblock1` (ops/resblock.py), on the card and
whenever `torch.export` traces, so that an exported program launches the
same kernel; an eager call on the CPU runs the plain version, the
operator's CPU implementation, directly.
"""
from __future__ import annotations

import torch

from ..ops.resblock import resblock1_reference
from .hifigan import Generator


class FastGenerator(Generator):
    """`Generator` with each ResBlock1 in one K1 call; `use_kernel = False`
    routes them to the plain version."""

    def resblock(self, x, p, dilations):
        args = (x, p["w1"], p["b1"], p["w2"], p["b2"], list(dilations))
        if not self.use_kernel or (x.device.type == "cpu"
                                   and not torch.compiler.is_compiling()):
            return resblock1_reference(*args)
        return torch.ops.si.resblock1(*args)
