"""The GAN trainer's modules (models/common.py, the trainable WNGenerator,
MultiPeriodDiscriminator, MultiScaleDiscriminator), the GAN losses, the
ops they need and the converters, against the JAX package's, on the CPU in
float32, fed the same numpy trees.

Tolerances:
  - WNGenerator at test_train_variants.py's TINY_G widths: forward atol
    2e-5; a VJP (parameters and input) within 2e-5 of each tensor's largest
    magnitude; `fold()` equal to `generator_from_jax` of the same tree;
  - MPD and MSD at full width on 2 × 2048 samples: every output and feature
    map within 1e-5 of its largest magnitude; batched (one 2B forward)
    against two calls bit-equal; the MSD's u/v after a train-mode call
    against JAX's mutated `spectral` collection rel 1e-5; eval mode leaves
    them as they were;
  - the four losses rel 1e-6 (f32 and bf16 inputs); avg_pool1d, the
    regrid and the new mel presets atol 1e-6 (mel 1e-4, its log scale).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_inpainting_tpu import losses as jl
from speech_inpainting_tpu.convert.hifigan_torch import (
    convert_mpd as jax_convert_mpd, convert_msd as jax_convert_msd)
from speech_inpainting_tpu.models import hifigan as jh
from speech_inpainting_tpu.ops import conv as jconv
from speech_inpainting_tpu.ops import mel as jmel
from speech_inpainting_tpu.ops import resize as jresize
from speech_inpainting_torch import losses as pl
from speech_inpainting_torch import testing
from speech_inpainting_torch.convert.from_jax import (
    generator_from_jax, generator_tree, mpd_from_jax, mpd_tree, msd_from_jax,
    msd_tree, spectral_tree, trainable_generator)
from speech_inpainting_torch.convert.hifigan_torch import (
    convert_mpd, convert_msd, load_discriminator_checkpoint,
    load_generator_checkpoint, load_trainable_generator)
from speech_inpainting_torch.models.hifigan import (Generator,
                                                    HiFiGANConfig,
                                                    MultiPeriodDiscriminator,
                                                    MultiScaleDiscriminator)
from speech_inpainting_torch.ops import conv as pconv
from speech_inpainting_torch.ops import mel as pmel
from speech_inpainting_torch.ops import resize as presize


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the full discriminators' convolutions, run by
    several test workers at once on one host, otherwise oversubscribe its
    cores many times over (OpenMP's spinning workers then slow every
    process by an order of magnitude)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)

TINY = dict(upsample_rates=(8, 2), upsample_kernel_sizes=(16, 4),
            upsample_initial_channel=16, resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 3),))
TINY_RB2 = dict(TINY, resblock="2", resblock_kernel_sizes=(3, 5),
                resblock_dilation_sizes=((1, 3), (1, 3)))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def assert_rel(got, want, rel, what=""):
    """Each leaf within rel × its largest magnitude (the same leaves)."""
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys(), what
    for k in w:
        scale = float(np.abs(w[k]).max()) or 1.0
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=rel * scale,
                                   err_msg=f"{what}{k}")


def discs(seed=0):
    """Full-width MPD and MSD (the port's init, drawn from `seed`) and
    their numpy trees, as both sides take them."""
    mpd = mpd_from_jax(device="cpu",
                       generator=torch.Generator().manual_seed(seed))
    msd = msd_from_jax(device="cpu",
                       generator=torch.Generator().manual_seed(seed + 1))
    return mpd, msd, mpd_tree(mpd), msd_tree(msd), spectral_tree(msd)


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x.detach().float().numpy() if hasattr(x, "detach") else \
        np.asarray(x, np.float32)


# ------------------------------------------------------------- the generator

@pytest.mark.parametrize("widths", [TINY, TINY_RB2], ids=["rb1", "rb2"])
def test_wn_generator_forward_and_vjp_match_flax(rng, widths):
    cfg = HiFiGANConfig(**widths)
    port = trainable_generator(cfg, device="cpu",
                               generator=torch.Generator().manual_seed(3))
    tree = generator_tree(port)
    mel = rng.standard_normal((2, 80, 9)).astype(np.float32)
    cot = rng.standard_normal((2, 1, 9 * 16)).astype(np.float32)
    gen = jh.Generator(jh.HiFiGANConfig(**widths))
    out, vjp = jax.vjp(lambda p, x: gen.apply({"params": p}, x),
                       jax.tree.map(jnp.asarray, tree), jnp.asarray(mel))
    g_params, g_mel = vjp(jnp.asarray(cot))
    x = torch.tensor(mel, requires_grad=True)
    y = port(x)
    y.backward(torch.tensor(cot))
    np.testing.assert_allclose(_np(y), np.asarray(out), atol=2e-5)
    assert_rel(generator_tree(port, of=lambda p: p.grad), g_params, 2e-5,
               "grad ")
    assert_rel({"mel": _np(x.grad)}, {"mel": g_mel}, 2e-5)
    # the inference form of the same weights
    folded = port.fold()
    assert type(folded) is Generator and not any(
        p.requires_grad for p in folded.parameters())
    ref = generator_from_jax(cfg, tree, device="cpu", cls=Generator)
    for a, b in zip(folded.state_dict().values(), ref.state_dict().values()):
        assert torch.equal(a, b)


def test_wn_generator_layout_and_init():
    """The reference's key names and shapes (weight_g (rows, 1, 1)), float32
    parameters that require grad, and the JAX package's inits: conv_pre
    torch's uniform, the rest N(0, 0.01), g = ‖v‖ per row."""
    cfg = HiFiGANConfig(**TINY)
    port = trainable_generator(cfg, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    sd = port.state_dict()
    assert sd["conv_pre.weight_g"].shape == (16, 1, 1)
    assert sd["ups.0.weight_g"].shape == (16, 1, 1)      # C_in rows
    assert sd["ups.0.weight_v"].shape == (16, 8, 16)
    assert "resblocks.1.convs2.1.weight_v" in sd
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in port.parameters())
    v = sd["ups.1.weight_v"]
    assert abs(float(v.std()) - 0.01) < 1e-3
    bound = 1 / np.sqrt(80 * 7)
    assert float(sd["conv_pre.weight_v"].abs().max()) <= bound
    assert float(sd["conv_pre.weight_v"].std()) > 0.5 * bound / np.sqrt(3)
    norm = v.pow(2).sum(dim=(1, 2), keepdim=True).sqrt()
    torch.testing.assert_close(sd["ups.1.weight_g"], norm)
    # the same generator seed draws the same weights
    again = trainable_generator(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in
               zip(sd.values(), again.state_dict().values()))


# ---------------------------------------------------------- discriminators

@pytest.fixture(scope="module")
def disc_setup():
    rng = np.random.default_rng(7)
    mpd, msd, mp, mv, spec = discs()
    y = (rng.standard_normal((2, 1, 2048)) * 0.3).astype(np.float32)
    y_hat = (rng.standard_normal((2, 1, 2048)) * 0.3).astype(np.float32)
    return mpd, msd, mp, mv, spec, y, y_hat


def test_mpd_matches_flax_and_batches_bit_equal(disc_setup):
    mpd, _, mp, _, _, y, y_hat = disc_setup
    want = jax.jit(lambda p, a, b: jh.MultiPeriodDiscriminator().apply(
        {"params": p}, a, b))(mp, y, y_hat)
    with torch.no_grad():
        got = mpd(torch.tensor(y), torch.tensor(y_hat))
        batched = mpd(torch.tensor(y), torch.tensor(y_hat), True)
    assert_rel(_np(got), [list(w) if isinstance(w, tuple) else w
                          for w in want], 1e-5)
    for a, b in zip(jax.tree.leaves(_np(got)), jax.tree.leaves(
            _np(batched))):
        np.testing.assert_array_equal(a, b)


def test_msd_matches_flax_its_power_iteration_and_eval(disc_setup):
    _, _, _, mv, spec, y, y_hat = disc_setup
    msd = msd_from_jax(mv, spec, device="cpu")
    apply = jax.jit(lambda p, s, a, b, train: jh.MultiScaleDiscriminator(
    ).apply({"params": p, "spectral": s}, a, b, train,
            mutable=["spectral"]), static_argnums=4)
    want, new = apply(mv, spec, y, y_hat, True)
    with torch.no_grad():
        got = msd(torch.tensor(y), torch.tensor(y_hat), True)
    assert_rel(_np(got), list(want), 1e-5)
    assert_rel(spectral_tree(msd), new["spectral"], 1e-5, "u/v ")
    # one iteration per call: real then fake moved u twice from `spec`
    assert not np.array_equal(
        spectral_tree(msd)["discriminators_0"]["convs_0"]["u"],
        spec["discriminators_0"]["convs_0"]["u"])
    # batched: scale 0 keeps its two calls, the rest one 2B forward
    twin = msd_from_jax(mv, spec, device="cpu")
    with torch.no_grad():
        b = twin(torch.tensor(y), torch.tensor(y_hat), True, True)
    for a, c in zip(jax.tree.leaves(_np(got)), jax.tree.leaves(_np(b))):
        np.testing.assert_array_equal(a, c)
    assert_rel(spectral_tree(twin), spectral_tree(msd), 0)
    # eval: the stored u/v, untouched
    before = spectral_tree(msd)
    want_eval, kept = apply(mv, new["spectral"], y, y_hat, False)
    with torch.no_grad():
        got_eval = msd(torch.tensor(y), torch.tensor(y_hat), False)
    assert_rel(spectral_tree(msd), before, 0)
    assert_rel(_np(got_eval), list(want_eval), 1e-5)
    assert_rel(kept["spectral"], new["spectral"], 0)


# --------------------------------------------------------------- the losses

@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_gan_losses_match_jax(rng, dtype):
    shapes = [[(2, 4, 5), (2, 1, 7)], [(2, 3, 9), (2, 6)]]
    mk = lambda: [[rng.standard_normal(s).astype(np.float32)  # noqa: E731
                   for s in d] for d in shapes]
    fr, fg = mk(), mk()
    outs_r = [d[-1].reshape(2, -1) for d in mk()]
    outs_g = [d[-1].reshape(2, -1) for d in mk()]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    J = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jdt), t)  # noqa
    T = lambda t: jax.tree.map(lambda a: torch.tensor(a).to(tdt), t)  # noqa
    pairs = [
        (jl.feature_loss(J(fr), J(fg)), pl.feature_loss(T(fr), T(fg))),
        (jl.discriminator_loss(J(outs_r), J(outs_g)),
         pl.discriminator_loss(T(outs_r), T(outs_g))),
        (jl.generator_loss(J(outs_g)), pl.generator_loss(T(outs_g))),
        (jl.mel_l1_loss(J(fr[0][0]).astype(jnp.float32),
                        J(fg[0][0]).astype(jnp.float32)),
         pl.mel_l1_loss(T(fr[0][0]).float(), T(fg[0][0]).float()))]
    for want, got in pairs:
        for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(
                jax.tree.map(lambda t: t.detach(), got))):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


# ------------------------------------------------------------------ the ops

def test_ops_match_jax(rng):
    x = rng.standard_normal((2, 3, 37)).astype(np.float32)
    np.testing.assert_allclose(
        pconv.avg_pool1d(torch.tensor(x), 4, 2, 2).numpy(),
        np.asarray(jconv.avg_pool1d(jnp.asarray(x), 4, 2, 2)), atol=1e-6)
    mel = rng.standard_normal((2, 80, 100)).astype(np.float32)
    for n in (173, 61):
        np.testing.assert_allclose(
            presize.regrid_mel_to(torch.tensor(mel), n).numpy(),
            np.asarray(jresize.regrid_mel_to(jnp.asarray(mel), n)),
            atol=1e-6)
    for name in ("VOCODER_MEL_22K_FULLBAND", "MODIFIED_MEL_22K"):
        p, j = getattr(pmel, name), getattr(jmel, name)
        assert (p.padding, p.fmax, p.hop_size) == (j.padding, j.fmax,
                                                   j.hop_size)
        wav = (rng.standard_normal((2, 44288)) * 0.3).astype(np.float32)
        np.testing.assert_allclose(
            pmel.mel_spectrogram(torch.tensor(wav), p).numpy(),
            np.asarray(jmel.mel_spectrogram(jnp.asarray(wav), j)),
            atol=1e-4)
    assert pmel.MODIFIED_MEL_22K.num_frames(44288) == 100
    assert pmel.VOCODER_MEL_22K.num_frames(44288) == 173


def test_loss_mel_takes_gradients_after_inference_mode(rng):
    """The cached STFT and mel bases, first made inside inference mode (an
    inference call before training, in one process), still serve a mel
    that carries a gradient to its waveform."""
    cfg = pmel.MelConfig(n_fft=512, num_mels=16, hop_size=128,
                         win_size=512, fmin=10.0)
    wav = torch.tensor(rng.standard_normal((1, 2048)).astype(np.float32))
    with torch.inference_mode():
        pmel.mel_spectrogram(wav, cfg)
    w = wav.clone().requires_grad_(True)
    pmel.mel_spectrogram(w, cfg).sum().backward()
    assert torch.isfinite(w.grad).all() and w.grad.abs().max() > 0


# ------------------------------------------------------------ the converters

def _new_style(sd: dict) -> dict:
    """A legacy state dict under the parametrizations API's key names."""
    sn = {k.rsplit(".", 1)[0] for k in sd if k.endswith(".weight_orig")}
    out = {}
    for k, v in sd.items():
        prefix, name = k.rsplit(".", 1)
        new = ({"weight_orig": "original", "weight_u": "_u", "weight_v": "_v"}
               if prefix in sn else
               {"weight_g": "original0", "weight_v": "original1"}).get(name)
        out[f"{prefix}.parametrizations.weight.{new}" if new else k] = v
    return out


def test_discriminator_converters_are_load_state_dict(tmp_path):
    mpd, msd, mp, mv, spec = discs(5)
    # the JAX package's converters read the port's state dicts as the
    # reference's
    assert_rel(jax_convert_mpd(mpd.state_dict()), mp, 0)
    jmv, jspec = jax_convert_msd(msd.state_dict())
    assert_rel(jmv, mv, 0)
    assert_rel(jspec, spec, 0)
    for sd_of in (lambda m: m.state_dict(),
                  lambda m: _new_style(m.state_dict())):
        a = convert_mpd(sd_of(mpd), device="cpu")
        b = convert_msd(sd_of(msd), device="cpu")
        for got, want in ((a, mpd), (b, msd)):
            plain = type(want)().to("cpu")
            plain.load_state_dict(want.state_dict())
            for x, y, z in zip(got.state_dict().values(),
                               want.state_dict().values(),
                               plain.state_dict().values()):
                assert torch.equal(x, y) and torch.equal(y, z)
    torch.save({"mpd": mpd.state_dict(), "msd": msd.state_dict(),
                "steps": 7, "epoch": 3}, tmp_path / "do_00000007")
    m2, s2, steps, epoch = load_discriminator_checkpoint(
        tmp_path / "do_00000007", device="cpu")
    assert (steps, epoch) == (7, 3)
    assert_rel(spectral_tree(s2), spec, 0)
    assert isinstance(m2, MultiPeriodDiscriminator) and isinstance(
        s2, MultiScaleDiscriminator)


def test_trainable_generator_loads_a_reference_g_file(tmp_path, rng):
    cfg = HiFiGANConfig(**TINY)
    tree = testing.generator_tree(cfg, rng)
    for sd in (testing.generator_state_dict(tree, cfg),
               _new_style(testing.generator_state_dict(tree, cfg))):
        torch.save({"generator": sd}, tmp_path / "g_00000001")
        gen = load_trainable_generator(tmp_path / "g_00000001", cfg,
                                       device="cpu")
        assert_rel(generator_tree(gen), tree, 0)
    # and the trainer's own state dict is such a file
    torch.save({"generator": gen.state_dict()}, tmp_path / "g_00000002")
    served = load_generator_checkpoint(tmp_path / "g_00000002", cfg,
                                       device="cpu", cls=Generator)
    mel = torch.tensor(rng.standard_normal((1, 80, 7)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(served(mel), gen.fold()(mel))
