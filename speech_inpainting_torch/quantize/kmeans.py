"""k-means: nearest-centroid assignment, codebook fitting and loading, the
counterpart of speech_inpainting_tpu/quantize/kmeans.py.

The distance keeps the reference's expansion ‖x‖² − 2x·c + ‖c‖²
(I_ea/dataset/km_label.py:26-34), one matrix product, and argmin takes the
first of equal distances, as jnp.argmin. `torch.cdist` would sum in another
order, and `argmin` could then pick another centroid at a near tie.

Fitting is the JAX package's: kmeans++ seeding (one D² candidate per step)
on a host-chosen subsample, then Lloyd iterations whose E and M steps run
chunk by chunk as GEMMs (distances, then one-hot sums), a dead cluster
restarting from a random data row, and `n_init` restarts keeping the lowest
inertia. Its random draws come from `torch.Generator`s seeded from `seed`:
they cannot reproduce `jax.random`'s streams, so a fit agrees with the JAX
package's in what is deterministic (the subsample, the statistics of a
pass, Lloyd from a shared start) and in its result's quality, not draw for
draw. Fitting runs on the CUDA card unless `device="cpu"` is asked for,
in full float32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import full_f32, resolve_device


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


def assign_and_distance(x: torch.Tensor, C: torch.Tensor):
    """(labels (...,), squared distance to the nearest centroid (...,))."""
    flat = x.reshape(-1, x.shape[-1])
    d = pairwise_sqdist(flat, C)
    labels = d.argmin(dim=-1)
    mind = d.gather(-1, labels[:, None])[:, 0]
    return labels.reshape(x.shape[:-1]), mind.reshape(x.shape[:-1])


def quantize_to_centroids(x: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Each vector replaced by its nearest centroid (the reference's mel_c
    centroid substitution, meldataset_modified.py:155-171)."""
    return C[assign(x, C)]


def _kmeanspp_init(gen: torch.Generator, x: torch.Tensor,
                   k: int) -> torch.Tensor:
    """kmeans++ seeding: a uniform first row, then k − 1 rows each drawn
    with probability ∝ its squared distance to the nearest chosen one."""
    first = x[torch.randint(x.shape[0], (), generator=gen,
                            device=x.device)]
    d2 = ((x - first) ** 2).sum(dim=-1)
    C = [first]
    for _ in range(k - 1):
        c = x[torch.multinomial(d2.clamp(min=1e-30), 1, generator=gen)[0]]
        C.append(c)
        d2 = torch.minimum(d2, ((x - c) ** 2).sum(dim=-1))
    return torch.stack(C)


def _chunked_stats(x: torch.Tensor, C: torch.Tensor, chunk: int):
    """One Lloyd E+M pass over x in `chunk`-row tiles: (sums (K, D),
    counts (K,), inertia). x's length must be a multiple of chunk."""
    k = C.shape[0]
    sums = x.new_zeros(k, x.shape[-1])
    counts = x.new_zeros(k)
    inertia = x.new_zeros(())
    for xb in x.split(chunk):
        labels, mind = assign_and_distance(xb, C)
        one_hot = torch.nn.functional.one_hot(labels, k).to(x.dtype)
        sums = sums + one_hot.t() @ xb
        counts = counts + one_hot.sum(dim=0)
        inertia = inertia + mind.sum()
    return sums, counts, inertia


def _lloyd(gen: torch.Generator, x: torch.Tensor, C: torch.Tensor,
           iters: int, chunk: int):
    """`iters` Lloyd steps from C: (centroids, the mean inertia of the last
    E step). A cluster left empty restarts from a random row of x."""
    n = x.shape[0]
    inertia = x.new_zeros(())
    for _ in range(iters):
        sums, counts, total = _chunked_stats(x, C, chunk)
        new = sums / counts.clamp(min=1.0)[:, None]
        rand = x[torch.randint(n, (C.shape[0],), generator=gen,
                               device=x.device)]
        C = torch.where((counts > 0)[:, None], new, rand)
        inertia = total / n
    return C, inertia


def _seeding_rows(n: int, init_sample: int, seed: int):
    """The subsample kmeans++ seeds from: None (all rows) when n ≤
    init_sample, else init_sample distinct rows chosen on the host (a
    choice without replacement on the device would sort all n)."""
    if n <= init_sample:
        return None
    return np.random.default_rng(seed).choice(n, init_sample, replace=False)


@torch.no_grad()
def fit_kmeans(x, k: int, *, iters: int = 50, seed: int = 1234,
               init_sample: int = 65536, chunk: int = 8192, n_init: int = 3,
               device=None):
    """Fit k-means on `device` (the CUDA card unless "cpu" is asked for):
    kmeans++ on a subsample, then Lloyd over all of x (rows repeated modulo
    n up to a whole number of chunks), `n_init` restarts from seeds seed,
    seed + 1, …, the lowest inertia kept. x (N, D) array-like. Returns
    (centroids (K, D) float32 on the device, mean inertia)."""
    device = resolve_device(device)
    with full_f32():
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, np.float32))
        x = x.to(device=device, dtype=torch.float32)
        n = x.shape[0]
        rows = _seeding_rows(n, init_sample, seed)
        sub = x if rows is None else x[torch.as_tensor(rows, device=device)]
        chunk = min(chunk, n)
        target = -(-n // chunk) * chunk
        if target != n:
            x = x[torch.arange(target, device=device) % n]
        best = (None, np.inf)
        for i in range(n_init):
            gen = torch.Generator(device=device)
            gen.manual_seed(seed + i)
            C, inertia = _lloyd(gen, x, _kmeanspp_init(gen, sub, k), iters,
                                chunk)
            inertia = float(inertia)
            if inertia < best[1]:
                best = (C, inertia)
    return best


def codebook_diagnostics(C) -> dict:
    """Pairwise codebook statistics (the reference's check_cos_sim
    diagnostics, km_label.py:96-115): cosine-similarity spread and centroid
    norms; high off-diagonal similarity flags a collapsed codebook."""
    C = np.asarray(C.cpu() if isinstance(C, torch.Tensor) else C, np.float64)
    n = C / np.maximum(np.linalg.norm(C, axis=1, keepdims=True), 1e-12)
    sim = n @ n.T
    off = sim[~np.eye(len(C), dtype=bool)]
    return {
        "k": len(C),
        "cos_sim_mean": float(off.mean()),
        "cos_sim_max": float(off.max()),
        "cos_sim_min": float(off.min()),
        "norm_mean": float(np.linalg.norm(C, axis=1).mean()),
        "norm_std": float(np.linalg.norm(C, axis=1).std()),
    }


@dataclasses.dataclass
class KMeans:
    """A codebook, rows = centroids (K, D) float32 on the host; the loaders
    read this package's `.npy` and the reference's sklearn models. Calls
    assign on the device of the vectors they are given."""
    centroids: np.ndarray

    def _on(self, x: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(self.centroids, dtype=torch.float32,
                               device=x.device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Labels of x (..., D)."""
        return assign(x, self._on(x))

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        return quantize_to_centroids(x, self._on(x))

    @property
    def k(self) -> int:
        return self.centroids.shape[0]

    @staticmethod
    def fit(x, k: int, **kw) -> "KMeans":
        C, _ = fit_kmeans(x, k, **kw)
        return KMeans(C.cpu().numpy())

    def save(self, path) -> None:
        np.save(path, self.centroids)

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
