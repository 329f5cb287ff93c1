"""Informed speech inpainting, the I_ea main path:

    wav22 ─ mask ─ peak-normalise ─ mel(hop 441) ───────────────────┐ splice ─ extend ─ HiFi-GAN ─ wav
    wav16 ─ mask ─ zero-mean/unit-var ─ HuBERT+head ─ nearest centroid ┘

Conventions (those of speech_inpainting_tpu/infer/inpaint.py):
  - 22.05 kHz mask span [pos·441, (pos+len)·441);
  - 16 kHz mask span [pos·320+80, (pos+len)·320−1);
  - inf-norm × 0.95 on the masked 22 kHz wave, (x−μ)/√(σ²+1e-7) on the 16 kHz
    one;
  - predicted frames = centred centroid[argmax cos] + codebook mean, spliced
    over mel frames [pos, pos+len) of the hop-441 mel, whose frame grid is
    HuBERT's 20 ms grid;
  - linear 441 → 256 regrid (extend_mel) before the generator.

The path from the staged inputs on is one module, `InpaintGraph`, which
`InformedInpainter.batch` calls and infer/aot.py exports.

Beside the main path, the reference's other artifacts: `batch_expected`
(the true centroid frames spliced in, the decoder-only upper bound) and
`hifi_masked` (the masked mel vocoded as it is).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..convert.from_jax import generator_from_jax, hubert_from_jax
from ..device import full_f32, resolve_device, stage
from ..models.hifigan import HiFiGANConfig
from ..models.hubert import HubertConfig
from ..ops.masking import frame_mask, mask_span, mask_wave_frames
from ..ops.mel import HUBERT_ALIGNED_MEL_22K, mel_spectrogram
from ..ops.resize import extend_mel


def peak_normalize(x: torch.Tensor, level: float = 0.95,
                   eps: float = 1e-10) -> torch.Tensor:
    """librosa.util.normalize(x) · level (inf-norm) over the last axis."""
    peak = x.abs().amax(dim=-1, keepdim=True).clamp(min=eps)
    return x * (level / peak)


def meanvar_normalize(x: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """HF Wav2Vec2FeatureExtractor do_normalize: (x−μ)/√(σ²+1e-7)."""
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mu) / torch.sqrt(var + eps)


@dataclasses.dataclass(frozen=True)
class InpainterConfig:
    hubert: HubertConfig
    hifigan: HiFiGANConfig
    normalize_16k: bool = True  # HF processor do_normalize


def _masked_mel22(wav22, mask_pos, mask_len):
    masked22 = mask_span(wav22, mask_pos * 441, mask_len * 441)
    return mel_spectrogram(peak_normalize(masked22), HUBERT_ALIGNED_MEL_22K)


def _splice(mel, frames_btd, mask_pos, mask_len):
    """Replace mel (B, 80, F) frames inside [pos, pos+len) with frames_btd
    (B, T, 80), padded with zeros or cut to the mel's F frames first."""
    n_frames = mel.shape[-1]
    t = frames_btd.shape[1]
    if t < n_frames:
        frames_btd = torch.nn.functional.pad(frames_btd,
                                             (0, 0, 0, n_frames - t))
    else:
        frames_btd = frames_btd[:, :n_frames]
    m = frame_mask(n_frames, mask_pos, mask_len, mel.device)
    return torch.where(m[:, None, :], frames_btd.transpose(1, 2), mel)


class InpaintGraph(nn.Module):
    """The body of `InformedInpainter.batch` as one module, which the live
    inpainter calls and `infer/aot.py` exports, so that the two cannot
    drift apart. Submodules: `hubert` (EncoderWithHead) and `generator`;
    buffers: the centred codebook `C_centered` (K, 80), its rows normalised
    `cn` and the codebook mean `center` (80,).

    forward(wav22 (B, T22) f32, wav16 (B, T16) f32, mask_pos, mask_len (B,)
    int64, in 20 ms frames) → inpainted (B, T), mel_masked and
    mel_inpainted (B, 80, F), pred_labels (B, frames)."""

    def __init__(self, hubert: nn.Module, generator: nn.Module,
                 centroids: torch.Tensor, normalize_16k: bool = True):
        super().__init__()
        self.hubert = hubert
        self.generator = generator
        self.normalize_16k = normalize_16k
        center = centroids.mean(dim=0)
        cc = centroids - center[None, :]
        self.register_buffer("center", center)
        self.register_buffer("C_centered", cc)
        self.register_buffer("cn", cc / cc.norm(dim=-1, keepdim=True).clamp(
            min=1e-8))

    def forward(self, wav22, wav16, mask_pos, mask_len) -> dict:
        mel = _masked_mel22(wav22, mask_pos, mask_len)        # (B, 80, F)

        masked16 = mask_wave_frames(wav16, mask_pos, mask_len)
        if self.normalize_16k:
            masked16 = meanvar_normalize(masked16)
        emb = self.hubert(masked16).float()                   # (B, T, 80)

        # nearest centroid by centred cosine similarity
        en = emb / emb.norm(dim=-1, keepdim=True).clamp(min=1e-8)
        pred_labels = torch.argmax(en @ self.cn.t(), dim=-1)  # (B, T)
        pred_mels = self.C_centered[pred_labels] + self.center

        inpainted_mel = _splice(mel, pred_mels, mask_pos, mask_len)
        wav = self.generator(extend_mel(inpainted_mel))
        return dict(inpainted=wav[:, 0], mel_masked=mel,
                    mel_inpainted=inpainted_mel, pred_labels=pred_labels)


class InformedInpainter:
    """Informed inpainting with HuBERT + head and a HiFi-GAN vocoder whose
    ResBlock1s run in the fused CUDA kernel (K1) on the card.

    hubert_params / generator_params: the JAX package's parameter trees
    (numpy). centroids: (K, 80) mel codebook, uncentred. Runs on the CUDA
    card unless `device="cpu"` is passed.

    `generator` overrides the vocoder: a loaded module with the same
    (B, in_dim, F) → (B, 1, T) contract, such as the iSTFT engine from
    `convert.from_jax.istft_generator_from_jax` or a FastGenerator from a
    reference `g_*` file (`convert.hifigan_torch`); `hubert` likewise takes
    a loaded EncoderWithHead (`convert.hubert_torch.convert_custom_model`).
    Each override excludes its tree: pass None for it.

    Every entry point returns as soon as its work is enqueued on the card
    (host arrays are staged through pinned memory); read the results, or
    wait on them (`infer.serving.force`), to synchronise.

    `mesh` (parallel/mesh.py): data-parallel batch serving over the ranks
    of a DeviceMesh, one per card (the reference's Pool(8) inference
    workers, I_da/scripts/inference.py:311-327). The weights and codebook
    are rank 0's on every rank, made so once here; each batch entry point
    computes this rank's rows of a batch whose size divides the mesh's dp
    axis and gathers the global result on every rank, as JAX's returns a
    global array. A batch that does not divide dp (the one-utterance
    `__call__`, B = 1), or a mesh without a dp axis, is computed whole on
    every rank: correct, just not distributed. `device` must be the
    mesh's.
    """

    def __init__(self, cfg: InpainterConfig, hubert_params, generator_params,
                 centroids, *, generator=None, hubert=None, device=None,
                 mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device)
        if mesh is not None:
            from ..parallel.mesh import on_mesh
            self.device = on_mesh(self.device, mesh)
        C = torch.as_tensor(centroids, dtype=torch.float32,
                            device=self.device)
        for name, tree, module in (("hubert", hubert_params, hubert),
                                   ("generator", generator_params,
                                    generator)):
            if (tree is None) == (module is None):
                raise ValueError(f"pass either {name}_params or the loaded "
                                 f"`{name}=` module, not both or neither")
        self.graph = InpaintGraph(
            hubert.to(self.device) if hubert is not None
            else hubert_from_jax(cfg.hubert, hubert_params,
                                 out_dim=C.shape[-1], device=self.device),
            generator.to(self.device) if generator is not None
            else generator_from_jax(cfg.hifigan, generator_params,
                                    device=self.device),
            C, cfg.normalize_16k)
        if mesh is not None:
            from ..parallel.mesh import replicate
            replicate(mesh, self.graph)

    def _sharded(self, fn, *inputs) -> dict:
        """fn(*inputs) over the batch: on a mesh whose dp axis divides the
        batch, this rank's rows, then every rank's outputs gathered in rank
        order (parallel/distributed.py:all_gather_rows); else whole."""
        mesh = self.mesh
        if mesh is None or "dp" not in mesh.mesh_dim_names:
            return fn(*inputs)
        dp = mesh.size(mesh.mesh_dim_names.index("dp"))
        if inputs[0].shape[0] % dp:
            return fn(*inputs)
        from ..parallel.distributed import all_gather_rows
        from ..parallel.mesh import data_index, rows
        index, count = data_index(mesh, "dp")
        out = fn(*(rows(x, index, count) for x in inputs))
        group = mesh.get_group("dp")
        return {k: all_gather_rows(v, group) for k, v in out.items()}

    @property
    def hubert(self) -> nn.Module:
        return self.graph.hubert

    @property
    def generator(self) -> nn.Module:
        return self.graph.generator

    def _inputs(self, wav22, mask_pos, mask_len):
        dev = self.device
        return (stage(wav22, torch.float32, dev),
                stage(mask_pos, torch.int64, dev),
                stage(mask_len, torch.int64, dev))

    @torch.inference_mode()
    @full_f32()
    def batch(self, wav22, wav16, mask_pos, mask_len) -> dict:
        """wav22 (B, T22), wav16 (B, T16) float; mask_pos, mask_len (B,) in
        20 ms frames. Returns inpainted (B, T), mel_masked and mel_inpainted
        (B, 80, F), pred_labels (B, frames). Float32 work runs in full
        float32 whatever the caller's TF32 flags (`device.full_f32`)."""
        wav22, mask_pos, mask_len = self._inputs(wav22, mask_pos, mask_len)
        wav16 = stage(wav16, torch.float32, self.device)
        return self._sharded(self.graph, wav22, wav16, mask_pos, mask_len)

    @torch.inference_mode()
    @full_f32()
    def batch_expected(self, wav22, target_labels, mask_pos,
                       mask_len) -> dict:
        """The oracle ('expected_inpaint'): the TRUE centroid frames,
        target_labels (B, F) on the whole mel frame grid, spliced over the
        masked span and vocoded. Returns expected_inpaint (B, T) and
        mel_expected (B, 80, F)."""
        wav22, mask_pos, mask_len = self._inputs(wav22, mask_pos, mask_len)
        labels = stage(target_labels, torch.int64, self.device)
        g = self.graph

        def expected(wav22, labels, mask_pos, mask_len):
            mel = _masked_mel22(wav22, mask_pos, mask_len)
            exp_mel = _splice(mel, g.C_centered[labels] + g.center,
                              mask_pos, mask_len)
            wav = self.generator(extend_mel(exp_mel))
            return dict(expected_inpaint=wav[:, 0], mel_expected=exp_mel)

        return self._sharded(expected, wav22, labels, mask_pos, mask_len)

    @torch.inference_mode()
    @full_f32()
    def _hifi_masked(self, wav22, mask_pos, mask_len) -> torch.Tensor:
        """The masked mel vocoded as it is, (B, T)."""
        wav22, mask_pos, mask_len = self._inputs(wav22, mask_pos, mask_len)

        def vocoded(wav22, mask_pos, mask_len):
            mel = _masked_mel22(wav22, mask_pos, mask_len)
            return {"wav": self.generator(extend_mel(mel))[:, 0]}

        return self._sharded(vocoded, wav22, mask_pos, mask_len)["wav"]

    def __call__(self, wav22, wav16, mask_pos: int, mask_len: int) -> dict:
        """One utterance: wav22 (T22,), wav16 (T16,); mask in 20 ms frames."""
        out = self.batch(torch.as_tensor(wav22)[None],
                         torch.as_tensor(wav16)[None],
                         torch.tensor([mask_pos]), torch.tensor([mask_len]))
        return {k: v[0] for k, v in out.items()}

    def expected_inpaint(self, wav22, target_labels, mask_pos: int,
                         mask_len: int) -> dict:
        """`batch_expected` on one utterance: target_labels (F,)."""
        out = self.batch_expected(torch.as_tensor(wav22)[None],
                                  torch.as_tensor(target_labels)[None],
                                  torch.tensor([mask_pos]),
                                  torch.tensor([mask_len]))
        return {k: v[0] for k, v in out.items()}

    def hifi_masked(self, wav22, mask_pos: int, mask_len: int
                    ) -> torch.Tensor:
        """The reference's 'hifi_masked.wav': one utterance's masked mel
        vocoded as it is, (T,)."""
        return self._hifi_masked(torch.as_tensor(wav22)[None],
                                 torch.tensor([mask_pos]),
                                 torch.tensor([mask_len]))[0]
