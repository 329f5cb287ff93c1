"""The port's I_da path (speech_inpainting_torch: ops/f0, quantize, models/
jukebox, models/codegen, the weight-normed Generator, infer/ida_inpaint and
infer/resynth) against the JAX package, on the CPU in float32, at
tests/test_ida_infer.py's small sizes, with the same numpy inputs and trees.

Tolerances, each with its reason:
  - discrete decisions (voicing, k-means units, VQ codes, pitch units) must
    agree exactly: the inputs are harmonic stretches far above the NCCF
    threshold, silence far below it, and codebooks whose nearest entries are
    far apart (the margins are asserted where the test does not control
    them);
  - f0 in Hz: rel 1e-5 on at least 98% of the frames and rel 2e-3 on all.
    f0 = sr / lag, the lag from float32 sums over 400 samples and a
    parabolic fit. torch's CPU grouped convolution sums those in another
    order than XLA's (its NCCF numerator was 6.5e-7 of the peak from a
    float64 run, XLA's 1.5e-7), and at voicing onsets, where the correlation
    window starts in near-silence, the peak fit amplifies that: 6 of 472
    frames differed by up to 0.16%, both results within 0.15% of float64;
  - features and distances: atol 1e-5 plus rel 1e-5 (float32 rounding of
    sums of ~100 terms); the generator's input features (embedding rows,
    repeated and concatenated) at atol 1e-5 too;
  - f0 of the whole I_da utterance: at most 1% of the frames beyond rel
    2e-3 (3 of 636 here, up to 5%). Where the 560-sample analysis frame
    straddles a voicing onset, its mean-removed reference window is nearly
    constant, the NCCF is within 1e-5 of its maximum at every lag, and the
    octave guard's pick is decided by rounding, in JAX as in the port. The
    normalised series the port vocodes is held at atol 1e-5 to JAX's
    normalisation of the port's own track, so that the wiring (population
    std, start-aligned trim) is tested exactly;
  - waveforms: atol 1e-4, as the I_ea generator's test (tanh outputs in
    [-1, 1] after a dozen convolutions). The generator weights carry the
    signal (`testing.generator_tree(carry=True)`), and each waveform test
    shows that swapping the content and pitch features moves the output by
    more than 100 times this tolerance.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from speech_inpainting_tpu.infer.ida_inpaint import IdaInpainter as JaxIda
from speech_inpainting_tpu.infer.resynth import Resynthesizer as JaxResynth
from speech_inpainting_tpu.models import codegen as jcodegen
from speech_inpainting_tpu.models import hifigan as jhifigan
from speech_inpainting_tpu.models import jukebox as jjukebox
from speech_inpainting_tpu.models.hubert import HubertConfig as JaxHub
from speech_inpainting_tpu.models.hubert import HubertModel as JaxHubert
from speech_inpainting_tpu.ops import f0 as jf0
from speech_inpainting_tpu.quantize import kmeans as jkmeans
from speech_inpainting_tpu.quantize.vq import Bottleneck as JaxBottleneck
from speech_inpainting_torch import testing
from speech_inpainting_torch.convert.from_jax import (codegen_from_jax,
                                                      hubert_model_from_jax)
from speech_inpainting_torch.infer.ida_inpaint import IdaInpainter
from speech_inpainting_torch.infer.resynth import Resynthesizer
from speech_inpainting_torch.models import codegen, hifigan, jukebox
from speech_inpainting_torch.models.hubert import HubertConfig
from speech_inpainting_torch.ops import f0
from speech_inpainting_torch.quantize import kmeans
from speech_inpainting_torch.quantize.vq import Bottleneck

ROOT = Path(__file__).resolve().parents[1]

# tests/test_ida_infer.py's sizes
STACK = dict(input_emb_width=1, output_emb_width=16, levels=1, downs_t=(2,),
             strides_t=(2,), width=8, depth=2, dilation_growth_rate=3)
F0Q = dict(l_bins=6, emb_width=16)
GEN = dict(upsample_rates=(5, 4, 4, 2, 2),
           upsample_kernel_sizes=(11, 8, 8, 4, 4), upsample_initial_channel=64,
           resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
           in_dim=48, sampling_rate=16000)
# the same with all three of V1's ResBlock1 kernel sizes
GEN3 = dict(GEN, resblock_kernel_sizes=(3, 7, 11),
            resblock_dilation_sizes=((1, 3, 5),) * 3)
HUB = dict(conv_dim=(8,) * 7, hidden_size=16, num_hidden_layers=2,
           num_attention_heads=2, intermediate_size=24,
           num_conv_pos_embeddings=15, num_conv_pos_embedding_groups=1)


def _cfgs(gen=GEN, external=True):
    """(JAX, port) CodeGeneratorConfig pair of one shape."""
    out = []
    for mod, juke, hg in ((jcodegen, jjukebox, jhifigan),
                          (codegen, jukebox, hifigan)):
        stack = juke.ConvStackConfig(**STACK)
        out.append(mod.CodeGeneratorConfig(
            hifigan=hg.HiFiGANConfig(**gen), num_embeddings=10,
            embedding_dim=16, external_speaker_emb=external,
            spk_embeddings=4,
            f0_quantizer=mod.FoVQVAEConfig(encoder=stack, decoder=stack,
                                           **F0Q)))
    return out


def _close(got, want, atol=1e-5, rtol=1e-5, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, **kw)


def _jax_feats(fn):
    """Run fn, recording each input of JAX's `Generator.__call__` (the
    concatenated conditioning features) as the jitted graph runs."""
    seen = []

    def grab(next_fun, args, kwargs, context):
        if (isinstance(context.module, jhifigan.Generator)
                and context.method_name == "__call__"):
            jax.debug.callback(lambda a: seen.append(np.asarray(a)),
                               args[0], ordered=True)
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(grab):
        out = fn()
    jax.effects_barrier()
    return out, seen


def _port_inputs(model, fn):
    """Run fn, recording what reaches the port's pitch quantizer
    (`model.fo_vqvae.encode_units`) and generator."""
    seen = {"f0": [], "feats": []}
    hook = model.generator.register_forward_pre_hook(
        lambda _, args: seen["feats"].append(args[0].numpy().copy()))
    encode_units = model.fo_vqvae.encode_units

    def grab(f0n):
        seen["f0"].append(f0n.numpy().copy())
        return encode_units(f0n)

    model.fo_vqvae.encode_units = grab
    try:
        return fn(), seen
    finally:
        hook.remove()
        del model.fo_vqvae.encode_units


def _same_feats(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        _close(g, w, rtol=0)


def _swap_moves_output(generator, feats, d, tol=1e-4):
    """Content (rows :d) and pitch (rows d:2d) swapped must move the
    waveform by more than 100 × the waveform tolerance."""
    x = torch.as_tensor(feats)
    swapped = torch.cat([x[:, d:2 * d], x[:, :d], x[:, 2 * d:]], dim=1)
    with torch.no_grad():
        moved = (generator(swapped) - generator(x)).abs().max().item()
    assert moved > 100 * tol, moved


def test_trees_have_the_jax_init_layout(rng):
    for external in (True, False):
        jcfg, cfg = _cfgs(external=external)
        params, vq = testing.codegen_tree(cfg, rng)
        spk = ({"emb": jnp.zeros((1, 16))} if external
               else {"spkr": jnp.zeros((1, 1), jnp.int32)})
        want = jax.eval_shape(
            lambda: jcodegen.CodeGenerator(jcfg).init(
                {"params": jax.random.PRNGKey(0),
                 "vq": jax.random.PRNGKey(1)},
                jnp.zeros((1, 8), jnp.int32), f0=jnp.zeros((1, 1, 32)),
                **spk))
        shapes = jax.tree_util.tree_map(lambda s: s.shape, want)
        assert jax.tree_util.tree_map(np.shape, params) == shapes["params"]
        assert jax.tree_util.tree_map(np.shape, vq) == shapes["vq"]
    hp = testing.hubert_model_tree(HubertConfig(**HUB), rng)
    want = jax.eval_shape(JaxHubert(JaxHub(**HUB)).init,
                          jax.random.PRNGKey(0), jnp.zeros((1, 3200)))
    assert jax.tree_util.tree_map(np.shape, hp) == jax.tree_util.tree_map(
        lambda s: s.shape, want["params"])


def test_config_from_da_json():
    with open(ROOT / "configs" / "da_hubert100_lut.json") as fh:
        h = json.load(fh)
    got = codegen.CodeGeneratorConfig.from_dict(h)
    want = jcodegen.CodeGeneratorConfig.from_dict(h)
    for field in ("num_embeddings", "embedding_dim", "multispkr", "use_f0",
                  "spk_embeddings", "external_speaker_emb"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.hifigan == hifigan.HiFiGANConfig.from_dict(h)
    assert got.hifigan.in_dim == 384 and got.hifigan.total_upsample == 320
    q, wq = got.f0_quantizer, want.f0_quantizer
    assert (q.l_bins, q.emb_width, q.levels) == (wq.l_bins, wq.emb_width,
                                                 wq.levels) == (20, 128, 1)
    assert dataclass_dict(q.encoder) == dataclass_dict(wq.encoder)
    assert q.encoder.total_stride == 16 and not got.content_vq
    assert got.code_encoder is want.code_encoder is None
    # the content-VQ regime's fields (lambda_commit_code,
    # code_encoder_params, code_vq_params), read as the JAX package does
    hv = dict(h, lambda_commit_code=1.0,
              code_encoder_params=dict(q.encoder.__dict__, width=16),
              code_vq_params={"l_bins": 50, "emb_width": 128, "mu": 0.9})
    got = codegen.CodeGeneratorConfig.from_dict(hv)
    want = jcodegen.CodeGeneratorConfig.from_dict(hv)
    assert got.content_vq
    assert dataclass_dict(got.code_encoder) == dataclass_dict(
        want.code_encoder)
    for field in ("code_vq_bins", "code_vq_width", "code_vq_mu"):
        assert getattr(got, field) == getattr(want, field), field
    assert (got.code_vq_bins, got.code_vq_width) == (50, 128)
    assert not hasattr(codegen.CodeGenerator(got), "emb_c")


def dataclass_dict(d):
    return {k: getattr(d, k) for k in d.__dataclass_fields__}


def test_f0_tracking_matches_jax(rng):
    cfg = f0.F0Config()
    audio = np.stack([testing.synthetic_utterance(rng, 1.2)
                      for _ in range(2)])
    want = np.asarray(jf0.extract_f0(audio, jf0.F0Config()))
    got = f0.extract_f0(torch.tensor(audio), cfg).numpy()
    assert got.shape == want.shape == (2, cfg.num_frames(audio.shape[1]))
    voiced = want > 0
    assert 0.3 < voiced.mean() < 0.9          # both kinds of frames occur
    np.testing.assert_array_equal(got > 0, voiced)
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert (rel > 1e-5).mean() <= 0.02 and rel.max() <= 2e-3
    # one utterance is row 0 of the batch, and the post-processing
    np.testing.assert_array_equal(f0.extract_f0(torch.tensor(audio[0])),
                                  got[0])
    mean, std = want[0].mean(), want[0].std()
    _close(f0.normalize_nonzero(torch.tensor(want[0]), mean, std),
           jf0.normalize_nonzero(want[0], mean, std))
    assert f0.f0_statistics(list(want)) == jf0.f0_statistics(list(want))
    x = rng.standard_normal((3, 11)).astype(np.float32)
    for width in (3, 4):
        _close(f0._median(torch.tensor(x), width), jf0._median(x, width))


def test_kmeans_assign_matches_jax(rng):
    C = rng.standard_normal((12, 24)).astype(np.float32)
    x = (C[rng.integers(0, 12, (3, 40))]
         + 0.3 * rng.standard_normal((3, 40, 24))).astype(np.float32)
    d = kmeans.pairwise_sqdist(torch.tensor(x.reshape(-1, 24)),
                               torch.tensor(C)).numpy()
    _close(d, jkmeans.pairwise_sqdist(x.reshape(-1, 24), C), atol=1e-4)
    top2 = np.sort(d, axis=-1)[:, :2]
    assert (top2[:, 1] - top2[:, 0]).min() > 1e-2   # no near tie
    np.testing.assert_array_equal(
        kmeans.assign(torch.tensor(x), torch.tensor(C)).numpy(),
        np.asarray(jkmeans.assign(x, C)))


@pytest.mark.parametrize("width", [16, 32])     # emb_width, 2·emb_width
def test_vq_encode_decode_match_jax(rng, width):
    k = rng.standard_normal((6, 16)).astype(np.float32)
    x = rng.standard_normal((2, width, 9)).astype(np.float32)
    vq = {"level_0": {"k": k, "k_sum": np.zeros_like(k),
                      "k_elem": np.zeros(6, np.float32),
                      "initted": np.ones((), bool)}}
    jb = JaxBottleneck(1, 6, 16)
    want = jb.apply({"vq": vq}, [x], method=jb.encode)[0]
    port = Bottleneck(1, 6, 16)
    port.level_0.k.copy_(torch.tensor(k))
    got = port.encode([torch.tensor(x)])[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _close(port.decode([got])[0],
           jb.apply({"vq": vq}, [want], method=jb.decode)[0])


def test_f0_encoder_and_pitch_units_match_jax(rng):
    jcfg, cfg = _cfgs()
    params, vq = testing.codegen_tree(cfg, rng)
    port = codegen_from_jax(cfg, params, vq, device="cpu")
    f0n = rng.standard_normal((2, 1, 64)).astype(np.float32)
    enc = jjukebox.Encoder(jcfg.f0_quantizer.encoder)
    want = enc.apply({"params": params["fo_vqvae"]["encoder"]},
                     jnp.asarray(f0n))[0]
    got = port.fo_vqvae.encoder(torch.tensor(f0n))[0]
    assert got.shape == want.shape == (2, 16, 16)
    _close(got, want)
    fo = jcodegen.FoVQVAE(jcfg.f0_quantizer)
    units = fo.apply({"params": {"encoder": params["fo_vqvae"]["encoder"]},
                      "vq": vq["fo_vqvae"]}, jnp.asarray(f0n),
                     method=fo.encode_units)
    np.testing.assert_array_equal(
        port.fo_vqvae.encode_units(torch.tensor(f0n)).numpy(),
        np.asarray(units))


@pytest.mark.parametrize("gen", [GEN, GEN3], ids=["k3", "k3-7-11"])
def test_weight_normed_generator_matches_flax(rng, gen):
    _, cfg = _cfgs(gen)
    params, vq = testing.codegen_tree(cfg, rng)
    feats = rng.standard_normal((1, 48, 6)).astype(np.float32)
    want = jax.jit(jhifigan.Generator(jhifigan.HiFiGANConfig(**gen)).apply)(
        {"params": params["generator"]}, jnp.asarray(feats))
    port = codegen_from_jax(cfg, params, vq, device="cpu").generator
    assert type(port) is hifigan.Generator
    got = port(torch.tensor(feats))
    assert got.shape == want.shape == (1, 1, 6 * 320)
    _close(got, want, atol=1e-4, rtol=0)
    port.use_kernel = False                # the plain route is the same here
    np.testing.assert_array_equal(port(torch.tensor(feats)).numpy(),
                                  got.numpy())
    _swap_moves_output(port, feats, 16)


@pytest.mark.parametrize("shape", [(2, 3, 4), (2, 3), (2,)])
def test_repeat_upsample_matches_jax(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    want = jcodegen.repeat_upsample(jnp.asarray(x), 8)
    got = codegen.repeat_upsample(torch.tensor(x), 8)
    assert got.shape == want.shape == (2, (shape + (1,))[1], 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("external", [True, False],
                         ids=["d-vector", "speaker-table"])
def test_codegen_and_resynthesizer_match_jax(rng, external):
    jcfg, cfg = _cfgs(external=external)
    params, vq = testing.codegen_tree(cfg, rng)
    # 32 content frames over 16 pitch units, so that each pitch unit is
    # repeated twice, as at full width (four times there)
    code = rng.integers(0, 10, (1, 32))
    f0n = rng.standard_normal((1, 1, 64)).astype(np.float32)
    spk = ({"emb": rng.standard_normal((1, 16)).astype(np.float32)}
           if external else {"spkr": np.array([[3]])})
    ref = JaxResynth(jcfg, params, vq)
    port = Resynthesizer(cfg, params, vq, device="cpu")
    (want, _), want_feats = _jax_feats(lambda: ref(code, f0=f0n, **spk))
    (got, rtf), got_in = _port_inputs(port.model,
                                      lambda: port(code, f0=f0n, **spk))
    _same_feats(got_in["feats"], want_feats)
    assert got.shape == want.shape == (1, 32 * 320) and rtf > 0
    _close(got, want, atol=1e-4, rtol=0)
    _swap_moves_output(port.model.generator, got_in["feats"][0], 16)
    # voice conversion: the f0 stream renormalised, the speaker swapped
    item = dict(code=code, f0=np.where(f0n > 0, f0n, 0.0), spkr=np.array(
        [[0]]), emb=spk.get("emb"))
    stats = {0: {"f0_mean": 150.0, "f0_std": 20.0},
             1: {"f0_mean": 220.0, "f0_std": 30.0}}
    want, _ = ref.voice_convert(item, 1, stats)
    got, _ = port.voice_convert(item, 1, stats)
    _close(got, want, atol=1e-4, rtol=0)


def test_ida_inpainter_matches_jax(rng):
    jcfg, cfg = _cfgs()
    params, vq = testing.codegen_tree(cfg, rng)
    hp = testing.hubert_model_tree(HubertConfig(**HUB), rng)
    audio = testing.synthetic_utterance(rng, 3.2)
    # centroids at HuBERT features of this utterance (clean and masked),
    # so that each frame has a clear nearest unit
    hub = hubert_model_from_jax(HubertConfig(**HUB), hp, device="cpu")
    with torch.no_grad():
        feats = hub(torch.tensor(audio)[None], tap_layer=1)[0].numpy()
    centroids = feats[rng.choice(len(feats), 10, replace=False)]
    emb = rng.standard_normal(16).astype(np.float32)
    ref = JaxIda(jcfg, params, vq, JaxHub(**HUB), hp, centroids, tap_layer=1)
    port = IdaInpainter(cfg, params, vq, HubertConfig(**HUB), hp, centroids,
                        tap_layer=1, device="cpu")
    want, want_feats = _jax_feats(lambda: ref(audio, mask_size=3200,
                                              emb=emb))
    got, got_in = _port_inputs(port.codegen,
                               lambda: port(audio, mask_size=3200, emb=emb))
    _same_feats(got_in["feats"], want_feats)   # two vocoder calls
    # the f0 series the port vocodes is JAX's normalisation of the port's
    # own track (the raw stream's mean and population std), trimmed from
    # the start
    track = f0.extract_f0(torch.tensor(audio)).numpy()
    f0n = np.asarray(jf0.normalize_nonzero(
        track, jnp.mean(track), jnp.maximum(jnp.std(track), 1e-8)))
    assert len(got_in["f0"]) == 2
    for g in got_in["f0"]:
        assert g.shape == (1, 1, got["audio_gen"].shape[0] // 80)
        _close(g[0, 0], f0n[:g.shape[-1]], rtol=0)
    # the track against JAX's: equal voicing; ties at voicing onsets
    want_track = np.asarray(jf0.extract_f0(audio, jf0.F0Config()))
    np.testing.assert_array_equal(track > 0, want_track > 0)
    rel = np.abs(track - want_track) / np.maximum(want_track, 1.0)
    assert (rel > 2e-3).mean() <= 0.01, np.flatnonzero(rel > 2e-3)
    for k in ("code_clean", "code_inpainted"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    ci, c = want["code_inpainted"], want["code_clean"]
    assert (ci != c[:len(ci)]).any()      # the mask changed some units
    for k in ("audio_gt", "audio_mask", "audio_gen", "audio_inpainted"):
        assert got[k].shape == want[k].shape, k
        _close(got[k], want[k], atol=1e-4, rtol=0, err_msg=k)
    assert got["audio_gen"].shape[0] % 1280 == 0 and got["rtf"] > 0
    _swap_moves_output(port.codegen.generator, got_in["feats"][0], 16)
    # the units' nearest centroid is clear of the runner-up
    d = jkmeans.pairwise_sqdist(feats, centroids)
    top2 = np.sort(np.asarray(d), axis=-1)[:, :2]
    assert (top2[:, 1] - top2[:, 0]).min() > 1e-3


def test_hubert_tap_layer_matches_jax(rng):
    hp = testing.hubert_model_tree(HubertConfig(**HUB), rng)
    wav = rng.standard_normal((1, 4000)).astype(np.float32) * 0.3
    port = hubert_model_from_jax(HubertConfig(**HUB), hp, device="cpu")
    model = JaxHubert(JaxHub(**HUB))
    apply = jax.jit(model.apply, static_argnames="tap_layer")
    for tap in (None, 1):
        want = apply({"params": hp}, jnp.asarray(wav), tap_layer=tap)
        with torch.no_grad():
            got = port(torch.tensor(wav), tap_layer=tap)
        _close(got, want, atol=1e-4, rtol=0)
