"""The I_da unit-conditioned vocoder: CodeGenerator over content units,
f0-VQ pitch units and a speaker embedding.

Counterpart of speech_inpainting_tpu/models/codegen.py:
  - FoVQVAE: jukebox Encoder → VQ Bottleneck → jukebox Decoder over an f0
    series (1 channel, 5 ms hop); `encode_units` stops at the pitch units;
  - CodeGenerator, unit-lookup regime: content-unit Embedding, pitch-unit
    Embedding, speaker as an external d-vector or an Embedding table, each
    repeat-upsampled to the longest stream, channel concat (model_in_dim) →
    HiFi-GAN `Generator`, whose ResBlock1s run in K2 on the card;
  - CodeGenerator, content-VQ regime (the reference's lambda_commit_code):
    a jukebox Encoder and a one-level VQ replace the unit Embedding; integer
    units dequantize through its codebook, a waveform goes through both,
    and the forward returns (wav, commit, metrics).
  - WNCodeGenerator, the unit HiFi-GAN trainer's form (train/da.py): the
    same conditioning, trainable, around a weight-normed `WNGenerator`,
    with the pitch quantizer frozen; `fold()` gives the inference
    CodeGenerator of its weights.
The flax `Embed` tables there are `nn.Embedding` here (`weight`
(num_embeddings, features), copied unchanged). `FoVQVAE.forward(train=True)`
is the pitch quantizer's training forward (train/f0vq.py), and
`forward(train=True)` of a content-VQ CodeGenerator the joint regime's: the
codebook's EMA update and restarts run inside it, from a CPU
`torch.Generator`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..quantize.vq import Bottleneck
from .hifigan import Generator, HiFiGANConfig, WNGenerator
from .jukebox import ConvStackConfig, Decoder, Encoder, init_conv_stack_


@dataclasses.dataclass(frozen=True)
class FoVQVAEConfig:
    encoder: ConvStackConfig = ConvStackConfig()
    decoder: ConvStackConfig = ConvStackConfig()
    l_bins: int = 20
    emb_width: int = 128
    mu: float = 0.99
    levels: int = 1

    @staticmethod
    def from_dict(h: dict) -> "FoVQVAEConfig":
        vq = h["f0_vq_params"]
        return FoVQVAEConfig(
            encoder=ConvStackConfig.from_dict(h["f0_encoder_params"]),
            decoder=ConvStackConfig.from_dict(h["f0_decoder_params"]),
            l_bins=vq["l_bins"], emb_width=vq["emb_width"],
            mu=vq.get("mu", 0.99), levels=vq.get("levels", 1))


class FoVQVAE(nn.Module):
    """f0 (B, 1, T) → (reconstruction, commit terms, metrics);
    `encode_units` is the CodeGenerator's tap, which needs no decoder."""

    def __init__(self, cfg: FoVQVAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg.encoder)
        self.vq = Bottleneck(cfg.levels, cfg.l_bins, cfg.emb_width, cfg.mu)
        self.decoder = Decoder(cfg.decoder)

    def forward(self, f0: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None, group=None):
        """f0 (B, 1, T) → (reconstruction (B, 1, T), per-level commit
        terms, per-level metrics). With `train` the codebooks update and
        restart from candidates drawn from `generator` (quantize/vq.py),
        and the latents pass straight through to the decoder. `group` is
        the JAX model's axis_name: the codebooks' sums run over its ranks'
        rows and their candidates come from its first rank."""
        _, h_q, commits, metrics = self.vq(self.encoder(f0), train=train,
                                           generator=generator, group=group)
        return self.decoder(h_q), commits, metrics

    def encode_units(self, f0: torch.Tensor) -> torch.Tensor:
        """f0 (B, 1, T) → discrete pitch units (B, T/total_stride)."""
        return self.vq.encode(self.encoder(f0))[0]


@dataclasses.dataclass(frozen=True)
class CodeGeneratorConfig:
    hifigan: HiFiGANConfig
    num_embeddings: int = 100          # content-unit vocabulary (100/500)
    embedding_dim: int = 128
    multispkr: bool = True
    use_f0: bool = True                # reference h.f0_stats truthiness
    spk_embeddings: int = 200          # Embedding-table speaker path
    external_speaker_emb: bool = True  # d-vector `emb` input vs `spkr` ids
    f0_quantizer: Optional[FoVQVAEConfig] = None
    # content-VQ regime (reference h.lambda_commit_code truthy,
    # model.py:54-59): a content encoder and codebook replace emb_c
    code_encoder: Optional[ConvStackConfig] = None
    code_vq_bins: int = 100
    code_vq_width: int = 128
    code_vq_mu: float = 0.99

    @property
    def content_vq(self) -> bool:
        return self.code_encoder is not None

    @staticmethod
    def from_dict(h: dict) -> "CodeGeneratorConfig":
        vq = h.get("code_vq_params") or {}
        return CodeGeneratorConfig(
            hifigan=HiFiGANConfig.from_dict(h),
            num_embeddings=h["num_embeddings"],
            embedding_dim=h["embedding_dim"],
            multispkr=bool(h.get("multispkr")),
            use_f0=bool(h.get("f0_stats")),
            f0_quantizer=(FoVQVAEConfig.from_dict(h["f0_quantizer"])
                          if h.get("f0_quantizer") else None),
            code_encoder=(ConvStackConfig.from_dict(h["code_encoder_params"])
                          if h.get("lambda_commit_code") else None),
            code_vq_bins=vq.get("l_bins", 100),
            code_vq_width=vq.get("emb_width", 128),
            code_vq_mu=vq.get("mu", 0.99))


def repeat_upsample(signal: torch.Tensor, max_frames: int) -> torch.Tensor:
    """Reference `_upsample` (model.py:78-119): repeat each frame
    max_frames//T times. signal: (B, C, T) | (B, C) | (B,)."""
    if signal.ndim == 2:
        signal = signal[:, :, None]
    elif signal.ndim == 1:
        signal = signal[:, None, None]
    t = signal.shape[-1]
    if max_frames % t != 0:
        raise NotImplementedError(
            "misalignment between condition features "
            f"(target {max_frames} not a multiple of source {t})")
    return torch.repeat_interleave(signal, max_frames // t, dim=2)


def _conditioning(module: nn.Module, cfg: CodeGeneratorConfig) -> None:
    """The unit, pitch and speaker streams' submodules, as the JAX
    CodeGenerator names them."""
    if cfg.content_vq:
        module.code_encoder = Encoder(cfg.code_encoder)
        module.code_vq = Bottleneck(1, cfg.code_vq_bins, cfg.code_vq_width,
                                    cfg.code_vq_mu)
    else:
        module.emb_c = nn.Embedding(cfg.num_embeddings, cfg.embedding_dim)
    if cfg.use_f0:
        if cfg.f0_quantizer is None:
            raise NotImplementedError(
                "only the f0-VQ pitch path is ported (f0_quantizer)")
        module.fo_vqvae = FoVQVAE(cfg.f0_quantizer)
        module.emb_p = nn.Embedding(cfg.f0_quantizer.l_bins,
                                    cfg.embedding_dim)
    if cfg.multispkr and not cfg.external_speaker_emb:
        module.emb_s = nn.Embedding(cfg.spk_embeddings, cfg.embedding_dim)


class CodeGenerator(nn.Module):
    """(code, f0, emb | spkr) → waveform (B, 1, frames·∏upsample_rates);
    in the content-VQ regime (code, emb) → (waveform, commit, metrics)."""

    def __init__(self, cfg: CodeGeneratorConfig):
        super().__init__()
        self.cfg = cfg
        _conditioning(self, cfg)
        self.generator = Generator(cfg.hifigan)
        self.requires_grad_(False)

    def encode_codes(self, x: torch.Tensor) -> torch.Tensor:
        """Waveform/features (B, C, T) → content units (B, frames) through
        the learned content VQ (the reference's infer_vqvae_codes)."""
        return self.code_vq.encode(self.code_encoder(x))[0]

    def _content_vq(self, code: torch.Tensor, train: bool,
                    generator: Optional[torch.Generator], group):
        """Integer units dequantize through the codebook (no commit term,
        whatever `train`); continuous input runs the encoder and the VQ
        (model.py:134-141), with `train` its training forward."""
        if not code.is_floating_point():
            return self.code_vq.level_0.decode(code), None, {}
        _, h_q, commits, metrics = self.code_vq(
            self.code_encoder(code), train=train, generator=generator,
            group=group, global_rows=True)
        return h_q[0], commits[0], metrics[0]

    def forward(self, code, f0=None, emb=None, spkr=None, *,
                train: bool = False,
                generator: Optional[torch.Generator] = None, group=None):
        """code (B, F) int, or in the content-VQ regime (B, F) int or
        (B, C, T) float; f0 (B, 1, Ff) float; emb (B, E) float d-vector or
        spkr (B,)/(B, 1) int ids. With `train`, a float `code` takes the
        content VQ's training forward: its codebook updates and restarts
        from candidates drawn from `generator` (quantize/vq.py); with a
        `group` it updates from the rows of all its ranks and draws its
        candidates from them, as the JAX package's mesh-jitted step does
        over the global batch. The pitch units take no gradient (the JAX
        model's stop_gradient)."""
        cfg = self.cfg
        if cfg.content_vq:
            # returns early, any d-vector concatenated (model.py:173-185;
            # these configs run without the f0 and speaker-table paths)
            feats, commit, metrics = self._content_vq(code, train, generator,
                                                      group)
            if emb is not None:
                feats = torch.cat(
                    [feats, repeat_upsample(emb, feats.shape[-1])], dim=1)
            return self.generator(feats), commit, metrics
        feats = emb_c = self.emb_c(code).transpose(1, 2)      # (B, D, F)
        if cfg.use_f0:
            with torch.no_grad():
                z_p = self.fo_vqvae.encode_units(f0)
            emb_p = self.emb_p(z_p).transpose(1, 2)           # (B, D, Fp)
            if emb_c.shape[-1] < emb_p.shape[-1]:
                emb_c = repeat_upsample(emb_c, emb_p.shape[-1])
            else:
                emb_p = repeat_upsample(emb_p, emb_c.shape[-1])
            feats = torch.cat([emb_c, emb_p], dim=1)
        if cfg.multispkr:
            if cfg.external_speaker_emb:
                if emb is None:
                    raise ValueError(
                        "multispkr with external_speaker_emb=True requires "
                        "an `emb` d-vector input")
                emb_s = emb
            else:
                emb_s = self.emb_s(spkr.reshape(spkr.shape[0]))
            feats = torch.cat(
                [feats, repeat_upsample(emb_s, feats.shape[-1])], dim=1)
        return self.generator(feats)


class WNCodeGenerator(CodeGenerator):
    """The trainable CodeGenerator (train/da.py): its conditioning as the
    inference form's, parameters float32 and requiring grad, the generator
    a weight-normed `WNGenerator` (ResBlock1 or ResBlock2), the pitch
    quantizer `fo_vqvae` frozen (no gradient, kept in eval mode; its
    units, taken under no_grad, are the JAX model's stop_gradient). A
    fresh init is drawn from `generator` as the JAX package's `model.init`
    draws its distributions: the embedding tables N(0, 1), the jukebox
    stacks by `init_conv_stack_`, then the WNGenerator's own inits; every
    codebook uninitialised (zero, `initted` False), as `init` leaves the
    `vq` collection."""

    def __init__(self, cfg: CodeGeneratorConfig,
                 generator: Optional[torch.Generator] = None):
        nn.Module.__init__(self)
        gen = generator or torch.Generator()
        self.cfg = cfg
        _conditioning(self, cfg)
        with torch.no_grad():
            for name in ("emb_c", "emb_p", "emb_s"):
                if hasattr(self, name):
                    w = getattr(self, name).weight
                    w.copy_(torch.randn(w.shape, generator=gen))
            if cfg.content_vq:
                init_conv_stack_(self.code_encoder, cfg.code_encoder, gen)
            if cfg.use_f0:
                init_conv_stack_(self.fo_vqvae.encoder,
                                 cfg.f0_quantizer.encoder, gen)
                init_conv_stack_(self.fo_vqvae.decoder,
                                 cfg.f0_quantizer.decoder, gen)
        self.generator = WNGenerator(cfg.hifigan, generator=gen)
        if cfg.use_f0:
            self.fo_vqvae.requires_grad_(False).eval()

    def train(self, mode: bool = True) -> "WNCodeGenerator":
        super().train(mode)
        if self.cfg.use_f0:
            self.fo_vqvae.eval()
        return self

    @torch.no_grad()
    def fold(self) -> CodeGenerator:
        """The inference CodeGenerator of these weights on the same device:
        the generator folded by `WNGenerator.fold()` (its ResBlock1s then
        run in K2 on the card), the embeddings, encoders and every codebook
        buffer copied."""
        folded = CodeGenerator(self.cfg)
        folded.generator = self.generator.fold()
        rest = {k: v for k, v in self.state_dict().items()
                if not k.startswith("generator.")}
        missing, unexpected = folded.load_state_dict(rest, strict=False)
        assert not unexpected and all(k.startswith("generator.")
                                      for k in missing), (missing, unexpected)
        return folded.to(self.generator.conv_pre.weight_v.device)
