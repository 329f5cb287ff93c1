"""Nearest-centroid assignment and codebook loading, the counterpart of
speech_inpainting_tpu/quantize/kmeans.py's `pairwise_sqdist`, `assign` and
`KMeans` (its loaders; fitting is not ported yet).

The distance keeps the reference's expansion ‖x‖² − 2x·c + ‖c‖²
(I_ea/dataset/km_label.py:26-34), one matrix product. `torch.cdist` would
sum in another order, and `argmin` could then pick another centroid at a
near tie.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def pairwise_sqdist(x: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """‖x−c‖² for x (N, D), C (K, D) → (N, K)."""
    x_sq = (x * x).sum(dim=-1)
    c_sq = (C * C).sum(dim=-1)
    return x_sq[:, None] - 2.0 * (x @ C.t()) + c_sq[None, :]


def assign(x: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid labels for x (..., D) against C (K, D) → (...,)
    int64 (the first of equal distances, as jnp.argmin)."""
    flat = x.reshape(-1, x.shape[-1])
    return pairwise_sqdist(flat, C).argmin(dim=-1).reshape(x.shape[:-1])


@dataclasses.dataclass
class KMeans:
    """A codebook, rows = centroids (K, D) float32 on the host; the loaders
    read this package's `.npy` and the reference's sklearn models."""
    centroids: np.ndarray

    @property
    def k(self) -> int:
        return self.centroids.shape[0]

    @staticmethod
    def load(path) -> "KMeans":
        return KMeans(np.asarray(np.load(path), np.float32))

    @staticmethod
    def load_joblib(path) -> "KMeans":
        """A reference sklearn MiniBatchKMeans model (joblib .km/.bin);
        needs `joblib`, which is imported here and only here."""
        import joblib
        km = joblib.load(path)
        return KMeans(np.asarray(km.cluster_centers_, np.float32))

    @staticmethod
    def load_auto(path) -> "KMeans":
        """By extension: reference joblib models (.km/.bin), else `.npy`
        centroids."""
        return (KMeans.load_joblib(path)
                if str(path).endswith((".km", ".bin")) else KMeans.load(path))
