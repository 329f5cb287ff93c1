"""I_da blind/informed inpainting: frozen HuBERT units + unit HiFi-GAN.

Counterpart of speech_inpainting_tpu/infer/ida_inpaint.py (the reference's
script I_da/scripts/inpainting.py:151-266), per utterance:

    audio ── zero-mask ── HuBERT(layer tap) ── k-means units ─┐ splice
    audio ──────────────  HuBERT(layer tap) ── k-means units ─┘   │
    audio ── f0 track ── voiced z-norm ────────────────────────── CodeGenerator ── wav

Conventions (those of the JAX package):
  - mask: (y + 1e-6) with zeros at [start, start+mask_size), default start
    1.5 s;
  - informed splice: unit frames outside the mask (on the code-frame scale)
    come from the clean stream, frames inside from the blind one;
  - f0 from the CLEAN audio, normalised by the raw stream's mean and
    population std (zeros included);
  - LCM length matching of (audio 1, code 320, f0 80) and the trim to a
    multiple of 16·80 samples that the pitch quantizer needs;
  - outputs inf-normalised (eps 1e-10).
The generator's ResBlock1s run in K2 on the card: 2 vocoder calls, each one
launch per residual step.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from ..convert.from_jax import codegen_from_jax, hubert_model_from_jax
from ..device import full_f32, resolve_device
from ..models.codegen import CodeGeneratorConfig
from ..models.hubert import HubertConfig
from ..ops.f0 import F0Config, extract_f0, normalize_nonzero
from ..ops.masking import mask_span
from ..quantize.kmeans import assign


def _peak_norm(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / x.abs().amax(dim=-1, keepdim=True).clamp(min=eps)


class IdaInpainter:
    """codegen_params / vq_tree / hubert_params: the JAX package's trees
    (numpy), or None where the loaded module is passed instead as
    `codegen=` (a CodeGenerator, e.g. from convert/ida_torch.py) or
    `hubert=` (a HubertModel, e.g. from convert/hubert_torch.py);
    centroids (K, hidden) k-means codebook over the tapped layer. Runs on
    the CUDA card unless `device="cpu"` is passed."""

    def __init__(self, codegen_cfg: CodeGeneratorConfig, codegen_params,
                 vq_tree, hubert_cfg: HubertConfig, hubert_params,
                 centroids, *, tap_layer: Optional[int] = None,
                 f0_cfg: F0Config = F0Config(), code_hop: int = 320,
                 codegen=None, hubert=None, device=None):
        self.cfg = codegen_cfg
        self.hubert_cfg = hubert_cfg
        self.tap_layer = tap_layer
        self.f0_cfg = f0_cfg
        self.code_hop = code_hop
        self.device = resolve_device(device)
        for name, tree, module in (("codegen", codegen_params, codegen),
                                   ("hubert", hubert_params, hubert)):
            if (tree is None) == (module is None):
                raise ValueError(f"pass either {name}_params or the loaded "
                                 f"`{name}=` module, not both or neither")
        self.codegen = (codegen.to(self.device) if codegen is not None
                        else codegen_from_jax(codegen_cfg, codegen_params,
                                              vq_tree, device=self.device))
        self.hubert = (hubert.to(self.device) if hubert is not None
                       else hubert_model_from_jax(hubert_cfg, hubert_params,
                                                  device=self.device))
        self.centroids = torch.as_tensor(centroids, dtype=torch.float32,
                                         device=self.device)

    def _units(self, audio: torch.Tensor) -> torch.Tensor:
        """audio (T,) → k-means units of the tapped layer (frames,)."""
        feats = self.hubert(audio[None], tap_layer=self.tap_layer)[0]
        return assign(feats.float(), self.centroids)

    @torch.inference_mode()
    @full_f32()
    def inpaint(self, audio, mask_start: int, mask_size: int, emb=None,
                spkr=None) -> Dict[str, torch.Tensor]:
        """audio (T,) float 16 kHz; mask in samples; emb (1, E) d-vector or
        spkr (1, 1) id. Returns audio_gt, audio_mask, audio_gen,
        audio_inpainted and the unit streams code_clean, code_inpainted.
        Float32 work runs in full float32 whatever the caller's TF32 flags
        (`device.full_f32`)."""
        audio = torch.as_tensor(audio, dtype=torch.float32,
                                device=self.device)
        masked = mask_span(audio + 1e-6, mask_start, mask_size)

        code_clean = self._units(audio)
        code_blind = self._units(masked)
        idx = torch.arange(code_clean.shape[0], device=self.device)
        inside = ((idx >= mask_start // self.code_hop)
                  & (idx < (mask_start + mask_size) // self.code_hop))
        code_inp = torch.where(inside, code_blind, code_clean)

        f0 = extract_f0(audio, self.f0_cfg)
        # the raw stream's mean and population std, zeros included
        # (reference inpainting.py:217)
        f0n = normalize_nonzero(f0, f0.mean(),
                                f0.std(correction=0).clamp(min=1e-8))

        unit = 320                                     # lcm(1, 320, 80)
        n_unit = min(audio.shape[-1] // unit, code_clean.shape[0],
                     f0n.shape[0] // 4)
        samples = n_unit * unit
        samples -= samples % (16 * 80)
        code_inp = code_inp[:samples // self.code_hop]
        code_clean_t = code_clean[:samples // self.code_hop]
        f0n = f0n[:samples // 80]

        def vocode(code):
            return self.codegen(code[None], f0=f0n[None, None, :], emb=emb,
                                spkr=spkr)[0, 0]

        audio_gen = vocode(code_clean_t)
        audio_inp = vocode(code_inp)
        return dict(audio_gt=_peak_norm(audio[:samples]),
                    audio_mask=_peak_norm(masked[:samples]),
                    audio_gen=_peak_norm(audio_gen.float()),
                    audio_inpainted=_peak_norm(audio_inp.float()),
                    code_clean=code_clean, code_inpainted=code_inp)

    def __call__(self, audio, mask_size: int, *,
                 mask_start: Optional[int] = None, emb=None,
                 spkr: Optional[int] = None) -> Dict:
        """audio (T,) float 16 kHz; mask_size in samples; emb (E,) d-vector
        or spkr id. Returns `inpaint`'s outputs (tensors on the device) and
        'rtf', wall seconds per second of generated audio, the card
        synchronised before the clock is read."""
        sr = self.cfg.hifigan.sampling_rate
        if mask_start is None:
            mask_start = int(sr * 3 / 2)               # reference fixed 1.5 s
        emb_t = None if emb is None else torch.as_tensor(
            emb, dtype=torch.float32, device=self.device)[None]
        spkr_t = None if spkr is None else torch.tensor(
            [[spkr]], device=self.device)
        t0 = time.perf_counter()
        out = self.inpaint(audio, mask_start, mask_size, emb_t, spkr_t)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        out["rtf"] = wall / (out["audio_gen"].shape[-1] / sr)
        return out
