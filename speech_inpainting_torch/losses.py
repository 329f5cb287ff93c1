"""The GAN losses, and the I_ea centroid losses against a k-means codebook
of mel frames.

Counterpart of speech_inpainting_tpu/losses.py:
  - the HiFi-GAN losses: LSGAN `discriminator_loss` and `generator_loss`,
    `feature_loss` (L1 over every feature map, ×2) and `mel_l1_loss`
    (×45), each reducing in float32 whatever type the discriminators
    computed in (GANConfig.disc_bf16);
  - `CentroidLosses`: the centred cosine loss −Σ(cos − 1), the sum-MSE
    against the uncentred centroids, the summed cross-entropy, each with
    its predicted labels, and the cosine between predicted and target
    centroids (the cos-sim accuracy metric). Argmax and argmin take the
    first extreme, as jnp's do.
`commit_loss` (the VQ-VAE commitment) waits for I_da training.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    """2 · Σ over discriminators and layers of mean |real − fake|."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(_f32(rl) - _f32(gl)))
    return loss * 2.0


def discriminator_loss(disc_real_outputs, disc_generated_outputs):
    """Σ mean((1 − D(y))²) + mean(D(ŷ)²), and the per-discriminator
    terms."""
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real_outputs, disc_generated_outputs):
        r_loss = torch.mean(torch.square(1.0 - _f32(dr)))
        g_loss = torch.mean(torch.square(_f32(dg)))
        loss = loss + (r_loss + g_loss)
        r_losses.append(r_loss)
        g_losses.append(g_loss)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs):
    """Σ mean((1 − D(ŷ))²), and the per-discriminator terms."""
    loss = 0.0
    gen_losses = []
    for dg in disc_outputs:
        g = torch.mean(torch.square(1.0 - _f32(dg)))
        gen_losses.append(g)
        loss = loss + g
    return loss, gen_losses


def mel_l1_loss(mel_real, mel_gen, weight: float = 45.0) -> torch.Tensor:
    """The reference's mel-spectrogram L1, scaled ×45 in the trainers."""
    return weight * torch.mean(torch.abs(mel_real - mel_gen))


class CentroidLosses:
    """`centroids`: (K, D) codebook, rows are centroids, on the device the
    losses run on."""

    def __init__(self, centroids, tau: float = 0.1, device=None):
        self.C = torch.as_tensor(centroids, dtype=torch.float32,
                                 device=device)                 # (K, D)
        self.center = self.C.mean(dim=0)                        # (D,)
        self.C_centered = self.C - self.center[None, :]         # (K, D)
        self.tau = tau

    def compute_targets(self) -> torch.Tensor:
        """Diagonal softmax mass of the pairwise centred-codebook cos-sim."""
        cn = self.C_centered / (
            torch.linalg.norm(self.C_centered, dim=-1, keepdim=True) + 1e-8)
        e = torch.exp(cn @ cn.T / self.tau)
        return torch.diagonal(e) / torch.sum(e, dim=-1)

    @staticmethod
    def _cos(a, b, eps: float = 1e-8):
        num = torch.sum(a * b, dim=-1)
        den = torch.linalg.norm(a, dim=-1) * torch.linalg.norm(b, dim=-1)
        return num / torch.clamp(den, min=eps)

    def cos_sim(self, output, labels):
        """Centred cosine loss −Σ(cos − 1) and argmax predicted labels.
        output: (B, T, D) frame embeddings; labels: (B, T) centroid ids."""
        flat = output.reshape(-1, output.shape[-1])
        tgt = self.C_centered[labels.reshape(-1)]
        loss = -torch.sum(self._cos(flat, tgt) - 1.0)
        sims = self._cos(flat[:, None, :], self.C_centered[None, :, :])
        return loss, torch.argmax(sims, dim=1).reshape(labels.shape)

    def mse(self, output, labels):
        """Sum-MSE against the uncentred centroids and the labels of least
        distance, ‖x‖² − 2x·c + ‖c‖²."""
        flat = output.reshape(-1, output.shape[-1])
        tgt = self.C[labels.reshape(-1)]
        loss = torch.sum(torch.square(flat - tgt))
        d = (torch.sum(flat ** 2, -1, keepdim=True) - 2.0 * flat @ self.C.T
             + torch.sum(self.C ** 2, -1)[None, :])
        return loss, torch.argmin(d, dim=-1).reshape(labels.shape)

    def soft_ce(self, logits, labels):
        """Summed cross-entropy over (B, T, K) logits and argmax labels."""
        flat = logits.reshape(-1, logits.shape[-1])
        logp = F.log_softmax(flat, dim=-1)
        lbl = labels.reshape(-1, 1).long()
        loss = -torch.sum(torch.gather(logp, -1, lbl))
        return loss, torch.argmax(flat, dim=-1).reshape(labels.shape)

    def cos_sim_pred_target(self, pred_labels, labels):
        """Cosine between predicted and target centred centroids (the
        reference's cos-sim accuracy, thresholded at 0.95)."""
        a = self.C_centered[pred_labels.reshape(-1)]
        b = self.C_centered[labels.reshape(-1)]
        return self._cos(a, b)
