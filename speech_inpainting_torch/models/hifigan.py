"""HiFi-GAN generator over folded weights, its trainable weight-normed form,
the discriminators, and the configuration (the reference's config_v1.json
keys).

Counterpart of speech_inpainting_tpu/models/hifigan.py:Generator. There the
convs are weight-normed (v, g) flax modules folded on every call; here weight
norm is folded once, when the weights are loaded (convert/from_jax.py), as
the reference's remove_weight_norm does. `Generator` sends each ResBlock1
through `ops.resblock.resblock1_forward`, one K2 kernel launch per residual
step when the generator lies on the card; models/hifigan_fast.py's
`FastGenerator` overrides only that call, for K1. ResBlock2 (config V3: two
steps of lrelu → dilated conv → residual) has no Pallas kernel in the JAX
package, so its convs are torch's, as are the others.

The GAN trainer takes the other form, `WNGenerator`: the JAX `Generator`'s
weight-normed convs as trainable modules (models/common.py) under the
reference's names, its ResBlocks the plain torch chain (K1 and K2 have no
backward, in the JAX package neither). `WNGenerator.fold()` returns the
folded `Generator` (K2) or `FastGenerator` (K1) of its weights, as a `g_*`
file of them loads; models/hifigan_istft.py's `WNISTFTGenerator` shares
its trunk under another head. The discriminators (`MultiPeriodDiscriminator`,
`MultiScaleDiscriminator`) are the JAX package's, with its four output
lists and its `batched` knob: real and fake as one 2B forward through each
weight-normed discriminator, never through the spectral-normed scale 0,
whose power iteration advances once per call in training.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import cast
from ..ops.conv import avg_pool1d, get_padding
from ..ops.resblock import resblock1_forward, resblock1_reference
from .common import SNConv1d, WNConv1d, WNConv2d, WNConvTranspose1d

LRELU_SLOPE = 0.1


@dataclasses.dataclass(frozen=True)
class HiFiGANConfig:
    resblock: str = "1"
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5))
    in_dim: int = 80          # 80 mels (I_ea) or model_in_dim=384 (I_da)
    sampling_rate: int = 22050
    dtype: torch.dtype = torch.float32

    @property
    def total_upsample(self) -> int:
        out = 1
        for u in self.upsample_rates:
            out *= u
        return out

    @staticmethod
    def from_dict(h: dict) -> "HiFiGANConfig":
        return HiFiGANConfig(
            resblock=str(h["resblock"]),
            upsample_rates=tuple(h["upsample_rates"]),
            upsample_kernel_sizes=tuple(h["upsample_kernel_sizes"]),
            upsample_initial_channel=h["upsample_initial_channel"],
            resblock_kernel_sizes=tuple(h["resblock_kernel_sizes"]),
            resblock_dilation_sizes=tuple(
                tuple(d) for d in h["resblock_dilation_sizes"]),
            in_dim=h.get("model_in_dim", h.get("num_mels", 80)) or 80,
            sampling_rate=h.get("sampling_rate", 22050),
        )


def resblock2(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              dilations=(1, 3)) -> torch.Tensor:
    """ResBlock2 over folded weights w (S, C, C, K), b (S, C): for each
    dilation d, x ← x + conv_d(lrelu(x)), "same" padding, slope 0.1."""
    K = w.shape[-1]
    for s, d in enumerate(dilations):
        xt = F.conv1d(F.leaky_relu(x, LRELU_SLOPE), w[s], b[s],
                      padding=get_padding(K, d), dilation=d)
        x = xt + x
    return x


class Generator(nn.Module):
    """mel/features (B, in_dim, F) → waveform (B, 1, F·∏upsample_rates).

    Parameters hold the folded kernels in the torch layouts: `conv_pre`,
    `ups[i]`, `conv_post` as Conv1d/ConvTranspose1d modules and, per
    ResBlock1, `resblocks[i·nk + j]` with w1, w2 (S, C, C, K) and b1, b2
    (S, C); per ResBlock2, w (S, C, C, K) and b (S, C). `use_kernel =
    False` routes the ResBlock1s through the plain version instead, for
    holding the kernel path against it.
    """

    def __init__(self, cfg: HiFiGANConfig):
        super().__init__()
        if cfg.resblock not in ("1", "2"):
            raise ValueError(f"resblock {cfg.resblock!r} is neither 1 nor 2")
        self.cfg = cfg
        self.use_kernel = True
        c0 = cfg.upsample_initial_channel
        self.conv_pre = nn.Conv1d(cfg.in_dim, c0, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                       cfg.upsample_kernel_sizes)):
            ch = c0 // (2 ** (i + 1))
            self.ups.append(nn.ConvTranspose1d(ch * 2, ch, k, stride=u,
                                               padding=(k - u) // 2))
            for rk, rd in zip(cfg.resblock_kernel_sizes,
                              cfg.resblock_dilation_sizes):
                s = len(rd)
                names = ("1", "2") if cfg.resblock == "1" else ("",)
                self.resblocks.append(nn.ParameterDict({
                    k + n: nn.Parameter(torch.empty(*shape))
                    for n in names for k, shape in (
                        ("w", (s, ch, ch, rk)), ("b", (s, ch)))}))
        self.conv_post = nn.Conv1d(c0 // 2 ** len(cfg.upsample_rates), 1, 7,
                                   padding=3)
        self.requires_grad_(False)

    def resblock(self, x, p, dilations):
        """One ResBlock1: K2 once per step (on the card), or the plain
        version."""
        if self.use_kernel:
            return resblock1_forward(x, p, dilations)
        return resblock1_reference(x, p["w1"], p["b1"], p["w2"], p["b2"],
                                   dilations)

    def trunk(self, mel: torch.Tensor) -> torch.Tensor:
        """conv_pre, then each upsampler and its multi-receptive-field
        fusion, then the leaky ReLU before conv_post."""
        cfg = self.cfg
        nk = len(cfg.resblock_kernel_sizes)
        x = self.conv_pre(cast(mel, self.conv_pre.weight.dtype))
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            xs = None
            for j, rd in enumerate(cfg.resblock_dilation_sizes):
                p = self.resblocks[i * nk + j]
                out = (self.resblock(x, p, tuple(rd)) if cfg.resblock == "1"
                       else resblock2(x, p["w"], p["b"], tuple(rd)))
                xs = out if xs is None else xs + out
            x = xs / nk
        return F.leaky_relu(x, 0.01)  # torch's default slope

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.conv_post(self.trunk(mel)))


# ------------------------------------------------------- the trainable form

class WNResBlock1(nn.Module):
    """MRF block: for each dilation d, x ← x + convs2(lrelu(convs1_d(
    lrelu(x))))."""

    def __init__(self, channels: int, kernel_size: int, dilation,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.dilation = tuple(dilation)
        conv = lambda d: WNConv1d(  # noqa: E731
            channels, channels, kernel_size, dilation=d,
            padding=get_padding(kernel_size, d), kernel_init="hifigan",
            dtype=dtype, generator=generator)
        self.convs1 = nn.ModuleList(conv(d) for d in self.dilation)
        self.convs2 = nn.ModuleList(conv(1) for _ in self.dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = c1(F.leaky_relu(x, LRELU_SLOPE))
            x = c2(F.leaky_relu(xt, LRELU_SLOPE)) + x
        return x


class WNResBlock2(nn.Module):
    """Lighter MRF block (V3): for each d, x ← x + convs_d(lrelu(x))."""

    def __init__(self, channels: int, kernel_size: int, dilation,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.convs = nn.ModuleList(WNConv1d(
            channels, channels, kernel_size, dilation=d,
            padding=get_padding(kernel_size, d), kernel_init="hifigan",
            dtype=dtype, generator=generator) for d in dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c in self.convs:
            x = c(F.leaky_relu(x, LRELU_SLOPE)) + x
        return x


class WNGenerator(nn.Module):
    """The trainable generator, mel/features (B, in_dim, F) → waveform (B, 1,
    F·∏upsample_rates), laid out as the reference's: `conv_pre`, `ups.{i}`,
    `resblocks.{n}.convs1/convs2.{s}` (ResBlock1) or `.convs.{s}`
    (ResBlock2), `conv_post`, each with weight_g/weight_v/bias. float32
    parameters, compute in cfg.dtype. Inits as the JAX package's: conv_pre
    torch's, ups, ResBlocks and conv_post N(0, 0.01), drawn from
    `generator`. `post_channels` is conv_post's width: 1 here, n_fft + 2
    under the iSTFT head (models/hifigan_istft.py)."""

    def __init__(self, cfg: HiFiGANConfig,
                 generator: torch.Generator | None = None,
                 post_channels: int = 1):
        super().__init__()
        if cfg.resblock not in ("1", "2"):
            raise ValueError(f"resblock {cfg.resblock!r} is neither 1 nor 2")
        gen = generator or torch.Generator()
        self.cfg = cfg
        dt = cfg.dtype
        c0 = cfg.upsample_initial_channel
        self.conv_pre = WNConv1d(cfg.in_dim, c0, 7, padding=3, dtype=dt,
                                 generator=gen)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        block = WNResBlock1 if cfg.resblock == "1" else WNResBlock2
        for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                       cfg.upsample_kernel_sizes)):
            ch = c0 // (2 ** (i + 1))
            self.ups.append(WNConvTranspose1d(
                2 * ch, ch, k, stride=u, padding=(k - u) // 2,
                kernel_init="hifigan", dtype=dt, generator=gen))
            for rk, rd in zip(cfg.resblock_kernel_sizes,
                              cfg.resblock_dilation_sizes):
                self.resblocks.append(block(ch, rk, rd, dt, gen))
        self.conv_post = WNConv1d(c0 // 2 ** len(cfg.upsample_rates),
                                  post_channels, 7, padding=3,
                                  kernel_init="hifigan", dtype=dt,
                                  generator=gen)

    def trunk(self, mel: torch.Tensor) -> torch.Tensor:
        """conv_pre, each upsampler and its multi-receptive-field fusion,
        then the leaky ReLU before conv_post."""
        nk = len(self.cfg.resblock_kernel_sizes)
        x = self.conv_pre(mel)
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            xs = None
            for j in range(nk):
                out = self.resblocks[i * nk + j](x)
                xs = out if xs is None else xs + out
            x = xs / nk
        return F.leaky_relu(x, 0.01)  # torch's default slope

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.conv_post(self.trunk(mel)))

    @torch.no_grad()
    def fold(self, cls: type | None = None) -> Generator:
        """The inference form of these weights on the same device, in
        cfg.dtype: `Generator` (ResBlock1s in K2; the default) or
        `FastGenerator` (K1), folded as a `g_*` file of this state dict
        loads (convert/hifigan_torch.py)."""
        from ..convert.hifigan_torch import convert_generator
        return convert_generator(self.state_dict(), self.cfg,
                                 device=self.conv_pre.weight_v.device,
                                 cls=cls or Generator)


# --------------------------------------------------------- the discriminators

class DiscriminatorP(nn.Module):
    """Period discriminator: the waveform reflect-padded to a multiple of
    p, folded to (B, C, T/p, p), then weight-normed 2-D convs over T/p."""

    def __init__(self, period: int, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.period = period
        chans = (1, 32, 128, 512, 1024)
        conv = lambda i, o, s: WNConv2d(  # noqa: E731
            i, o, (5, 1), (s, 1), (2, 0), dtype=dtype, generator=generator)
        self.convs = nn.ModuleList(
            [conv(chans[i], chans[i + 1], 3) for i in range(4)]
            + [conv(1024, 1024, 1)])
        self.conv_post = WNConv2d(1024, 1, (3, 1), (1, 1), (1, 0),
                                  dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor):
        fmap = []
        b, c, t = x.shape
        p = self.period
        if t % p:
            x = F.pad(x, (0, p - t % p), mode="reflect")
        x = x.reshape(b, c, -1, p)
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(b, -1), fmap


def _split(out, fmap, b):
    return out[:b], out[b:], [f[:b] for f in fmap], [f[b:] for f in fmap]


class MultiPeriodDiscriminator(nn.Module):
    """DiscriminatorP at each period, `discriminators.{i}`."""

    def __init__(self, periods=(2, 3, 5, 7, 11),
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.discriminators = nn.ModuleList(
            DiscriminatorP(p, dtype=dtype, generator=generator)
            for p in periods)

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor,
                batched: bool = False):
        """(D(y)s, D(ŷ)s, fmaps of y, fmaps of ŷ), one entry per period;
        batched=True runs (y, ŷ) as one 2B forward per period."""
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        b = y.shape[0]
        x2 = torch.cat([y, y_hat], dim=0) if batched else None
        for d in self.discriminators:
            if batched:
                y_d_r, y_d_g, fmap_r, fmap_g = _split(*d(x2), b)
            else:
                y_d_r, fmap_r = d(y)
                y_d_g, fmap_g = d(y_hat)
            y_d_rs.append(y_d_r)
            fmap_rs.append(fmap_r)
            y_d_gs.append(y_d_g)
            fmap_gs.append(fmap_g)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs


# (features, kernel, stride, groups, padding) of DiscriminatorS' convs
_SCALE_SPECS = ((128, 15, 1, 1, 7), (128, 41, 2, 4, 20), (256, 41, 2, 16, 20),
                (512, 41, 4, 16, 20), (1024, 41, 4, 16, 20),
                (1024, 41, 1, 16, 20), (1024, 5, 1, 1, 2))


class DiscriminatorS(nn.Module):
    """Scale discriminator: grouped 1-D convs, spectral-normed on scale 0,
    weight-normed on the others."""

    def __init__(self, use_spectral_norm: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.use_spectral_norm = use_spectral_norm
        conv = SNConv1d if use_spectral_norm else WNConv1d
        c_in = 1
        convs = []
        for f, k, s, g, pd in _SCALE_SPECS:
            convs.append(conv(c_in, f, k, stride=s, groups=g, padding=pd,
                              dtype=dtype, generator=generator))
            c_in = f
        self.convs = nn.ModuleList(convs)
        self.conv_post = conv(c_in, 1, 3, stride=1, padding=1, dtype=dtype,
                              generator=generator)

    def forward(self, x: torch.Tensor, train: bool = True):
        """train=True advances the spectral norm's power iteration (once
        per call); eval uses the stored u, v."""
        kw = {"update_stats": train} if self.use_spectral_norm else {}
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x, **kw), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x, **kw)
        fmap.append(x)
        return x.reshape(x.shape[0], -1), fmap


class MultiScaleDiscriminator(nn.Module):
    """DiscriminatorS at `scales` scales, `discriminators.{i}`, each on the
    previous scale's input average-pooled (4, 2, 2)."""

    def __init__(self, scales: int = 3, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.discriminators = nn.ModuleList(
            DiscriminatorS(use_spectral_norm=(i == 0), dtype=dtype,
                           generator=generator) for i in range(scales))

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor,
                train: bool = True, batched: bool = False):
        """As MultiPeriodDiscriminator's; scale 0 takes (y, ŷ) in two calls
        even when batched: its power iteration advances between them."""
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        b = y.shape[0]
        for i, d in enumerate(self.discriminators):
            if i:
                y = avg_pool1d(y, 4, 2, 2)
                y_hat = avg_pool1d(y_hat, 4, 2, 2)
            if batched and i:
                y_d_r, y_d_g, fmap_r, fmap_g = _split(
                    *d(torch.cat([y, y_hat], dim=0), train), b)
            else:
                y_d_r, fmap_r = d(y, train)
                y_d_g, fmap_g = d(y_hat, train)
            y_d_rs.append(y_d_r)
            fmap_rs.append(fmap_r)
            y_d_gs.append(y_d_g)
            fmap_gs.append(fmap_g)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs
