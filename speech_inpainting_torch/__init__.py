"""PyTorch/CUDA port of speech_inpainting_tpu.

The informed-inpainting main path (HuBERT-base → nearest-centroid splice →
HiFi-GAN V1) runs here on an NVIDIA card, with every HiFi-GAN ResBlock1 in a
hand-written CUDA kernel (``csrc/resblock1.cu``). The JAX package beside this
one stays the reference that each module is tested against; nothing here
imports it or JAX.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
