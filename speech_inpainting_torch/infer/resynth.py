"""Unit resynthesis with the CodeGenerator: an RTF meter and the
voice-conversion sweep.

Counterpart of speech_inpainting_tpu/infer/resynth.py:
  - `__call__`: generate + RTF = wall / audio-seconds (the reference's
    `generate`, I_da/src/dataset.py:225-244);
  - `voice_convert`: fill the speaker with a target speaker and renormalise
    the voiced f0 stream from source to target statistics
    (I_da/scripts/inference.py:200-222).
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ..convert.from_jax import codegen_from_jax
from ..device import full_f32, resolve_device
from ..models.codegen import CodeGeneratorConfig


class Resynthesizer:
    """cfg, params, vq_tree: the CodeGenerator's configuration and the JAX
    package's trees (numpy). Runs on the CUDA card unless `device="cpu"` is
    passed."""

    def __init__(self, cfg: CodeGeneratorConfig, params, vq_tree, *,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = codegen_from_jax(cfg, params, vq_tree,
                                      device=self.device)

    def _as(self, a, dtype):
        return None if a is None else torch.as_tensor(a, dtype=dtype,
                                                      device=self.device)

    @torch.inference_mode()
    @full_f32()
    def __call__(self, code, f0=None, emb=None, spkr=None):
        """code (B, F) [+ f0 (B, 1, Ff), emb (B, E) | spkr (B,)] → (wav
        (B, T) on the device, rtf): wall seconds per generated audio second,
        the card synchronised before the clock is read. Float32 work runs in
        full float32 whatever the caller's TF32 flags (`device.full_f32`)."""
        args = (self._as(code, torch.int64), self._as(f0, torch.float32),
                self._as(emb, torch.float32), self._as(spkr, torch.int64))
        t0 = time.perf_counter()
        wav = self.model(*args)[:, 0].float()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        sr = self.cfg.hifigan.sampling_rate
        return wav, wall / (wav.shape[0] * wav.shape[-1] / sr)

    def voice_convert(self, item: Dict, target_spkr: int, f0_stats: Dict,
                      target_emb: Optional[np.ndarray] = None):
        """Re-synthesize an item as another speaker: swap spkr/emb and map
        voiced f0 from source to target statistics."""
        src = f0_stats.get(int(item["spkr"].reshape(-1)[0]), f0_stats)
        tgt = f0_stats.get(int(target_spkr), f0_stats)
        f0 = np.asarray(item["f0"], np.float32)
        denorm = f0 * src["f0_std"] + src["f0_mean"]
        renorm = (denorm - tgt["f0_mean"]) / max(tgt["f0_std"], 1e-8)
        f0 = np.where(f0 != 0, renorm, 0.0).astype(np.float32)
        emb = target_emb if target_emb is not None else item.get("emb")
        if emb is not None and np.asarray(emb).ndim == 1:
            emb = np.asarray(emb)[None]
        spkr = np.full_like(np.asarray(item["spkr"]).reshape(1, -1)[:, :1],
                            target_spkr)
        code = np.asarray(item["code"])
        return self(code[None] if code.ndim == 1 else code,
                    f0 if f0.ndim == 3 else f0[None], emb, spkr)
