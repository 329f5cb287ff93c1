"""The I_da speaker embedding of speech_inpainting_tpu/data/code_dataset.py:
`mel_stats_embedder`, the self-contained stand-in for the reference's
TorchScript Resemblyzer d-vector (I_da/src/dataset.py:283-284) that the
`inpaint_da` CLI conditions on. The rest of that module (`CodeDataset`,
`F0Dataset`) belongs to I_da training and is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import full_f32, resolve_device
from ..ops.mel import MelConfig, mel_spectrogram

# 25 ms windows every 10 ms at 16 kHz, the full band
EMBED_MEL_16K = MelConfig(sampling_rate=16000, n_fft=400, num_mels=80,
                          hop_size=160, win_size=400, fmax=None)


def mel_stats_embedder(dim: int = 256, device=None):
    """Deterministic speaker embedding: mean ⊕ std over time of a
    25 ms / 10 ms log-mel, tiled/truncated to `dim` and L2-normalised.
    Returns embed(wav (T,) float 16 kHz, sr) → (dim,) float32 numpy; the
    mel runs on `device` (the CUDA card unless "cpu" is asked for)."""
    device = resolve_device(device)

    def embed(wav: np.ndarray, sr: int) -> np.ndarray:
        if sr != 16000:
            raise ValueError(f"mel_stats_embedder takes 16 kHz audio, "
                             f"got {sr} Hz")
        x = torch.as_tensor(np.asarray(wav, np.float32), device=device)
        with torch.inference_mode(), full_f32():
            mel = mel_spectrogram(x, EMBED_MEL_16K).cpu().numpy()
        stats = np.concatenate([mel.mean(axis=1), mel.std(axis=1)])
        reps = int(np.ceil(dim / stats.size))
        emb = np.tile(stats, reps)[:dim].astype(np.float32)
        return emb / (np.linalg.norm(emb) + 1e-8)

    return embed
