"""The port's `train_da` CLI (cli/train_da.py), the GAN loop's sweep over a
trainable CodeGenerator (train/run.py:gan_valid_fn) and the g_/do_ pair
with the restart candidates' generator (utils/checkpoints.py), on the CPU
on a tiny corpus of test_cli_trainers.py's kind (:211-249): 0.5 s wavs of
two speakers, random units, a config with the f0-VQ pitch path and
`multispkr`, its generator upsampling 320× at 32 channels (the I_da
inpainter's unit hop). The CLI's discriminators are cut to one period
and one scale (full width), as the step tests cut them, which makes each
do_ file a quarter of the full ones' ~1 GB.

Checked: the g_ and do_ files, and a rerun that resumes (its steps); the
validation sweep's mel error equal to `make_da_eval` of the folded module
on the same batch (rel 1e-6); both `--f0-quantizer` branches (a directory
that train_f0vq's layout fills, a reference f0-VQ-VAE g_ file), the pitch
quantizer loaded bit-equal and left so by training; the RNG state of the
joint regime's restart candidates written to do_ and restored; the
refusals; the JAX CLI's joint branch over CodeDataset raising, which the
port refuses at startup; and the trained generator folded through
`IdaInpainter` equal to the inpainter built from its JAX trees (atol
1e-6).
"""
import functools
import json
import shutil

import numpy as np
import pytest
import torch

from speech_inpainting_torch import testing
from speech_inpainting_torch.cli import train_da
from speech_inpainting_torch.convert.from_jax import (codegen_tree,
                                                      trainable_fo_vqvae)
from speech_inpainting_torch.convert.ida_torch import load_fo_vqvae_checkpoint
from speech_inpainting_torch.data.audio import save_wav
from speech_inpainting_torch.data.code_dataset import (CodeDataset,
                                                       CodeDatasetConfig,
                                                       mel_stats_embedder)
from speech_inpainting_torch.data.manifests import parse_manifest
from speech_inpainting_torch.infer.ida_inpaint import IdaInpainter
from speech_inpainting_torch.models.codegen import FoVQVAEConfig
from speech_inpainting_torch.models.hubert import HubertConfig
from speech_inpainting_torch.ops.mel import MelConfig
from speech_inpainting_torch.train.da import (DATrainConfig, make_da_eval,
                                              make_da_step)
from speech_inpainting_torch.train.f0vq import F0VQConfig, create_f0vq_state
from speech_inpainting_torch.train.run import RunConfig, run_gan_training
from speech_inpainting_torch.utils.checkpoints import Checkpointer
from test_torch_da_joint import batches, configs, port_trees
from test_torch_da_step import port_state
from test_torch_gan_models import _leaves, _two_threads  # noqa: F401

F0_STACK = dict(input_emb_width=1, output_emb_width=16, levels=1,
                downs_t=[2], strides_t=[2], width=8, depth=2,
                dilation_growth_rate=3)
F0_QUANTIZER = {"f0_vq_params": {"l_bins": 6, "emb_width": 16, "mu": 0.99,
                                 "levels": 1},
                "f0_encoder_params": F0_STACK, "f0_decoder_params": F0_STACK}
MEL = dict(num_mels=80, n_fft=1024, hop_size=256, win_size=1024, fmin=0,
           fmax_for_loss=None)
CONFIG = dict(resblock="1", upsample_rates=[5, 4, 4, 4],
              upsample_kernel_sizes=[11, 8, 8, 8],
              upsample_initial_channel=32, resblock_kernel_sizes=[3],
              resblock_dilation_sizes=[[1, 3]], model_in_dim=48,
              num_embeddings=10, embedding_dim=16, multispkr="_",
              f0_stats="f0_stats.json", f0_quantizer=F0_QUANTIZER,
              lambda_commit_code=0, sampling_rate=16000, segment_size=2560,
              code_hop_size=320, batch_size=2, **MEL)
# the JAX CLI's joint branch: test_train_da_vq.py's content-VQ stack, one
# 320× upsampler (JAX's eager init and its step's trace take a while a
# stage)
JOINT = dict(CONFIG, upsample_rates=[320], upsample_kernel_sizes=[640],
             multispkr=None, f0_stats=None, f0_quantizer=None,
             lambda_commit_code=0.02,
             code_encoder_params=dict(F0_STACK, depth=1),
             code_vq_params=dict(l_bins=10, emb_width=16))
SAMPLES = 8000


@pytest.fixture(autouse=True)
def _drop_files(tmp_path):
    """Each test's checkpoints go with it: a do_ file holds the
    discriminators and both optimizers' moments (~250 MB here)."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(autouse=True)
def _cut_discriminators(monkeypatch):
    """The CLI's discriminators: MPD period 2 and one MSD scale, drawn from
    the seeds default_discriminators uses."""
    def cut(cfg, device=None, seeds=(1, 2)):
        from speech_inpainting_torch.convert.from_jax import (mpd_from_jax,
                                                              msd_from_jax)
        gens = [torch.Generator().manual_seed(s) for s in seeds]
        return (mpd_from_jax(None, (2,), device=device, generator=gens[0]),
                msd_from_jax(None, None, 1, device=device,
                             generator=gens[1]))

    monkeypatch.setattr(train_da, "default_discriminators", cut)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three 0.5 s utterances (two training, one validation) with random
    units, both configs, a train_f0vq-layout directory and a reference
    f0-VQ-VAE g_ file, and the data cache both CLIs read."""
    d = tmp_path_factory.mktemp("da")
    rng = np.random.default_rng(31)
    lines = []
    for i in range(3):
        path = d / f"s{i % 2}_{i:02d}.wav"
        save_wav(path, testing.synthetic_utterance(rng, SAMPLES / 16000),
                 16000)
        units = rng.integers(0, 10, SAMPLES // 320)
        lines.append(json.dumps({"audio": str(path),
                                 "hubert": " ".join(map(str, units))}))
    (d / "train.txt").write_text("\n".join(lines[:2]) + "\n")
    (d / "valid.txt").write_text(lines[2] + "\n")
    (d / "da.json").write_text(json.dumps(CONFIG))
    (d / "joint.json").write_text(json.dumps(JOINT))
    f0cfg = FoVQVAEConfig.from_dict(F0_QUANTIZER)
    model = trainable_fo_vqvae(f0cfg, seed=2, device="cpu")
    with torch.no_grad():
        model.vq.level_0.k.copy_(torch.randn(6, 16, generator=torch.Generator(
        ).manual_seed(3)))
        model.vq.level_0.initted.fill_(True)
    Checkpointer(d / "f0vq").save("g_", 7, create_f0vq_state(
        F0VQConfig(model=f0cfg), model).state_dict(), wait=True)
    params, vq = testing.fo_vqvae_tree(f0cfg, rng)
    torch.save({"generator": testing.fo_vqvae_state_dict(params, vq, f0cfg)},
               d / "g_f0_reference")
    # the items the CLIs cache (the JAX CLI reads the same keys and files)
    mel = MelConfig(sampling_rate=16000, n_fft=1024, num_mels=80,
                    hop_size=256, win_size=1024, fmin=0, fmax=None)
    for name in ("train.txt", "valid.txt"):
        files, codes = parse_manifest(d / name)
        CodeDataset(files, codes, CodeDatasetConfig(
            segment_size=2560, mel=mel), cache_dir=str(d / "cache"),
            device="cpu")
    return d


def _args(d, ckpt, *extra, config="da.json"):
    return ["--config", str(d / config), "--train-manifest",
            str(d / "train.txt"), "--checkpoint-path", str(ckpt),
            "--epochs", "1", "--cache-dir", str(d / "cache"), "--device",
            "cpu", *extra]


def _sweeps(monkeypatch):
    """Every validation sweep's result, in order, and its batches."""
    seen = {"means": [], "batches": None}
    real = train_da.gan_valid_fn

    def spy(eval_fn, val_batches, **kw):
        seen["batches"] = val_batches
        inner = real(eval_fn, val_batches, **kw)

        def valid_fn(state, **kw2):
            seen["means"].append(inner(state, **kw2))
            return seen["means"][-1]
        return valid_fn

    monkeypatch.setattr(train_da, "gan_valid_fn", spy)
    return seen


def _cfg(state) -> DATrainConfig:
    """The CLI's DATrainConfig of CONFIG, for the eval alone."""
    mel = MelConfig(sampling_rate=16000, n_fft=1024, num_mels=80,
                    hop_size=256, win_size=1024, fmin=0, fmax=None)
    return DATrainConfig(codegen=state.generator.cfg, mel_loss=mel,
                         segment_size=CONFIG["segment_size"])


def _frozen(module) -> dict:
    return {k: v.clone() for k, v in module.fo_vqvae.state_dict().items()}


def test_train_da_cli_resumes_validates_and_inpaints(corpus, tmp_path,
                                                     capsys, monkeypatch):
    """--f0-quantizer a train_f0vq directory, a validation sweep every
    step: g_/do_ written, the pitch quantizer loaded from the directory
    and left bit-equal, a rerun resuming 1 → 2 with its own sweep; each
    sweep's mel error that of make_da_eval on the folded module; then the
    trained generator, folded, through IdaInpainter."""
    seen = _sweeps(monkeypatch)
    ckpt = tmp_path / "ck"
    args = _args(corpus, ckpt, "--f0-quantizer", str(corpus / "f0vq"),
                 "--valid-manifest", str(corpus / "valid.txt"),
                 "--validation-interval", "1")
    first = train_da.main(args)
    out = capsys.readouterr().out
    assert f"loaded frozen f0 quantizer from {corpus / 'f0vq'}" in out
    assert first.step == 1
    assert sorted(p.name for p in ckpt.iterdir()) == ["do_00000001",
                                                      "g_00000001"]
    # the generator's input width from the batch: two 16-wide embeddings
    # and the 256-wide d-vector of mel_stats_embedder
    assert first.generator.cfg.hifigan.in_dim == 16 + 16 + 256
    saved = Checkpointer(corpus / "f0vq").restore("g_")
    want = {**saved["params"], **saved["vq"]}
    got = first.generator.fo_vqvae.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    g = torch.load(ckpt / "g_00000001", weights_only=True)
    assert torch.equal(g["generator"]["fo_vqvae.vq.level_0.k"],
                       want["vq.level_0.k"])
    do = torch.load(ckpt / "do_00000001", weights_only=True)
    assert do["steps"] == 1 and "rng" not in do
    assert len(seen["means"]) == 1
    direct = make_da_eval(_cfg(first))(first.generator, seen["batches"][0])
    np.testing.assert_allclose(seen["means"][0]["mel_error"],
                               direct["mel_error"], rtol=1e-6)

    second = train_da.main(args)
    assert "resumed from step 1" in capsys.readouterr().out
    assert second.step == 2 and len(seen["means"]) == 2
    assert sorted(p.name for p in ckpt.iterdir()) == [
        "do_00000001", "do_00000002", "g_00000001", "g_00000002"]
    for k, v in _frozen(second.generator).items():
        assert torch.equal(v, want[k]), k
    moved = codegen_tree(second.generator)[0]["emb_c"]["weight"]
    assert not np.array_equal(moved, codegen_tree(first.generator)[0][
        "emb_c"]["weight"])

    # the trained generator in the I_da inpainter, folded, against the
    # inpainter built from its JAX trees
    rng = np.random.default_rng(5)
    from test_torch_ida import HUB
    hcfg = HubertConfig(**HUB)
    hp = testing.hubert_model_tree(hcfg, rng)
    audio = testing.synthetic_utterance(rng, 1.6)
    centroids = rng.standard_normal((10, 16)).astype(np.float32)
    emb = mel_stats_embedder(256, device="cpu")(audio, 16000)
    cfg = second.generator.cfg
    folded = IdaInpainter(cfg, None, None, hcfg, hp, centroids, tap_layer=1,
                          codegen=second.generator.fold(), device="cpu")
    params, vq = codegen_tree(second.generator)
    from_trees = IdaInpainter(cfg, params, vq, hcfg, hp, centroids,
                              tap_layer=1, device="cpu")
    a = folded(audio, mask_size=3200, emb=emb)
    b = from_trees(audio, mask_size=3200, emb=emb)
    n = a["audio_gen"].shape[0]
    assert n > 0 and n % (16 * 80) == 0
    assert torch.isfinite(a["audio_inpainted"]).all()
    for k in ("audio_gen", "audio_inpainted"):
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=1e-6)


def test_train_da_cli_reads_a_reference_f0_quantizer(corpus, tmp_path,
                                                     capsys):
    """--f0-quantizer a reference f0-VQ-VAE g_ file (no training:
    --epochs 0 saves the start)."""
    state = train_da.main(_args(corpus, tmp_path / "ck", "--f0-quantizer",
                                str(corpus / "g_f0_reference"), "--epochs",
                                "0"))
    assert "loaded frozen f0 quantizer" in capsys.readouterr().out
    want = load_fo_vqvae_checkpoint(corpus / "g_f0_reference",
                                    state.generator.cfg.f0_quantizer,
                                    device="cpu").state_dict()
    got = state.generator.fo_vqvae.state_dict()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert not any(p.requires_grad for p in
                   state.generator.fo_vqvae.parameters())
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "do_00000000", "g_00000000"]


def test_joint_state_checkpoints_its_rng(tmp_path):
    """The joint regime's loop writes the restart candidates' generator
    state to do_ and a rerun restores it with the steps and the
    codebook (the JAX package's `rng` in do_)."""
    rng = np.random.default_rng(8)
    params, vq, discs = port_trees(rng)
    _, pcfg = configs()
    bs = batches(rng, 1)
    run = RunConfig(epochs=1, checkpoint_dir=str(tmp_path / "ck"),
                    stdout_interval=1)
    first = run_gan_training(
        make_da_step(pcfg), port_state(pcfg, params, vq, discs,
                                       content_vq=True, seed=11),
        lambda epoch: iter(bs), run)
    do = torch.load(tmp_path / "ck" / "do_00000001", weights_only=True)
    assert torch.equal(do["rng"], first.rng.get_state())
    assert not torch.equal(do["rng"],
                           torch.Generator().manual_seed(11).get_state())
    fresh = port_state(pcfg, params, vq, discs, content_vq=True, seed=99)
    second = run_gan_training(make_da_step(pcfg), fresh, lambda epoch: iter(
        []), run)
    assert second.step == 1
    assert torch.equal(second.rng.get_state(), first.rng.get_state())
    a, b = (_leaves(codegen_tree(s.generator)[1]) for s in (first, second))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert bool(second.generator.code_vq.level_0.initted)


@pytest.mark.parametrize("extra", [["--mesh"], ["--coordinator", "h:1"],
                                   ["--num-processes", "1"],
                                   ["--process-id", "0"]])
def test_train_da_cli_refuses_the_distributed_flags(corpus, tmp_path, extra,
                                                    capsys):
    """The distributed flags as the JAX CLI takes them: --mesh trains over
    the ranks of the group it joins (a gloo group of one here) and
    --num-processes 1 is a single-process run (each for zero epochs: the
    g_/do_ of step 0); a coordinator without the rest, or a process id
    without a coordinator, raises as initialize does."""
    args = _args(corpus, tmp_path / "ck", *extra, "--epochs", "0")
    if extra[0] in ("--coordinator", "--process-id"):
        with pytest.raises(ValueError, match="coordinator_address"):
            train_da.main(args)
        return
    state = train_da.main(args)
    assert state.step == 0
    assert (state.mesh is not None) == (extra == ["--mesh"])
    assert not torch.distributed.is_initialized()
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "do_00000000", "g_00000000"]


def _jitted_init(cls):
    """`cls`, a flax module, whose `init` runs under jax.jit."""
    import jax

    class Jitted(cls):
        def init(self, rngs, *args, **kw):
            return jax.jit(lambda r: cls.init(self, r, *args, **kw))(rngs)

    return Jitted


def test_joint_branch_over_code_dataset(corpus, tmp_path, capsys,
                                        monkeypatch):
    """The JAX CLI's joint branch (a lambda_commit_code config) over
    CodeDataset's integer units raises as it traces its first step:
    an integer code dequantizes with commit None, and the step computes
    lambda_commit * None. The port's CLI refuses that config at startup,
    naming it. (For time, the JAX run's discriminators are cut to one
    period and one scale, its modules' `init` runs jitted (eager, each op
    compiles on its own), and its data comes from the cache the port
    wrote under the same keys; the trace reaches the failing line as
    before.)"""
    from speech_inpainting_tpu.cli import train_da as jax_train_da
    from speech_inpainting_tpu.models import hifigan as jh
    from speech_inpainting_tpu.train import gan as jgan
    mpd = functools.partial(_jitted_init(jh.MultiPeriodDiscriminator),
                            periods=(2,))
    msd = functools.partial(_jitted_init(jh.MultiScaleDiscriminator),
                            scales=1)
    for module in (jax_train_da, jgan):
        monkeypatch.setattr(module, "MultiPeriodDiscriminator", mpd)
        monkeypatch.setattr(module, "MultiScaleDiscriminator", msd)
    monkeypatch.setattr(jax_train_da, "CodeGenerator",
                        _jitted_init(jax_train_da.CodeGenerator))
    args = _args(corpus, tmp_path / "jax", config="joint.json")[:-2]
    with pytest.raises(TypeError, match="'float' and 'NoneType'"):
        jax_train_da.main(args)
    with pytest.raises(SystemExit):
        train_da.main(_args(corpus, tmp_path / "ck", config="joint.json"))
    err = capsys.readouterr().err
    assert "lambda_commit_code" in err and "integer units" in err
