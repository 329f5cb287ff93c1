"""The port's GAN loop (train/run.py's run_gan_training and gan_valid_fn),
its g_/do_ checkpoints (utils/checkpoints.py) and the logger's audio and
mel figure (utils/logging.py), on the CPU: the real GAN step over
test_torch_gan_step.py's TINY_G generator and reduced discriminators
(MPD period 2, one MSD scale). g_/do_ at the interval and at the end; a
resume that continues bit-equal to a run that never stopped; both partial
restores; the step cap; SIGTERM saving and returning; the nonfinite abort
saving first; validation scalars, audio and mel figure; and the g_ file
read back by `load_generator_checkpoint` as the trained module's fold()."""
import glob
import os
import shutil
import signal

import numpy as np
import pytest
import torch

from speech_inpainting_torch.convert.from_jax import (msd_from_jax,
                                                      mpd_from_jax,
                                                      trainable_generator)
from speech_inpainting_torch.convert.hifigan_torch import (
    load_generator_checkpoint)
from speech_inpainting_torch.models.hifigan import Generator
from speech_inpainting_torch.train import gan as pgan
from speech_inpainting_torch.train import hifigan as phg
from speech_inpainting_torch.train.run import (RunConfig, gan_valid_fn,
                                               run_gan_training)
from speech_inpainting_torch.utils.checkpoints import (Checkpointer,
                                                       scan_checkpoint)
from speech_inpainting_torch.utils.logging import TrainLogger
from test_torch_gan_step import SEG, configs
from test_torch_gan_models import _two_threads  # noqa: F401
from torch_dist import group_of_one  # noqa: F401


_, PCFG = configs(skip_nonfinite=2)


def new_state(seed=0):
    gen = trainable_generator(PCFG.hifigan, device="cpu",
                              generator=torch.Generator().manual_seed(seed))
    mpd = mpd_from_jax(None, (2,), device="cpu",
                       generator=torch.Generator().manual_seed(1))
    msd = msd_from_jax(None, None, 1, device="cpu",
                       generator=torch.Generator().manual_seed(2))
    return pgan.create_gan_state(PCFG.gan, gen, mpd, msd)


STEP = phg.make_vanilla_step(PCFG)


@pytest.fixture(autouse=True)
def _drop_files(tmp_path):
    """Each test's checkpoints go with it: a do_ file holds the
    discriminators and both optimizers' moments (up to 1 GB)."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def data(n, nan_from=None):
    def make(epoch):
        rng = np.random.default_rng(epoch)
        for i in range(n):
            audio = (rng.standard_normal((2, 1, SEG)) * 0.2).astype(
                np.float32)
            if nan_from is not None and i >= nan_from:
                audio[0, 0, 5] = np.nan
            yield {"audio": audio}
    return make


def run_cfg(tmp_path, **kw):
    return RunConfig(**{**dict(epochs=1, checkpoint_dir=str(tmp_path),
                               checkpoint_interval=2,
                               validation_interval=1000,
                               stdout_interval=1), **kw})


def flat(state):
    sd = state.state_dict()
    out = {f"{m}.{k}": v for m in ("generator", "mpd", "msd")
           for k, v in sd[m].items()}
    for o in ("optim_g", "optim_d"):
        for i, st in sd[o]["state"].items():
            out.update({f"{o}.{i}.{k}": v for k, v in st.items()})
    return out, sd["step"]


def test_checkpoints_resume_bit_equal(tmp_path, capsys):
    first = run_gan_training(STEP, new_state(), data(3),
                             run_cfg(tmp_path / "b"))
    names = sorted(p.name for p in (tmp_path / "b").iterdir())
    assert names == ["do_00000002", "do_00000003", "g_00000002",
                     "g_00000003"]
    assert "Steps: 3, fm_f:" in capsys.readouterr().out
    # a fresh state resumes from the newest g_/do_ and runs its own epoch
    # (epoch 0 again: --epochs counts this run's epochs, as in JAX)
    resumed = run_gan_training(STEP, new_state(5), data(3),
                               run_cfg(tmp_path / "b"))
    assert "resumed from step 3" in capsys.readouterr().out
    assert first.step == 3 and resumed.step == 6
    # the same six steps without a stop (both runs drew epoch 0's
    # batches twice): bit-equal parameters, u/v, moments and counts
    again = run_gan_training(STEP, new_state(), lambda e: data(3)(0),
                             run_cfg(tmp_path / "c", epochs=2))
    b, sb = flat(resumed)
    c, sc = flat(again)
    assert sb == sc == 6 and b.keys() == c.keys()
    for k in b:
        assert (torch.equal(b[k], c[k]) if torch.is_tensor(b[k])
                else b[k] == c[k]), k


def test_partial_restores(tmp_path, capsys):
    src = run_gan_training(STEP, new_state(), data(2), run_cfg(tmp_path))
    ck = Checkpointer(tmp_path)
    g_only, do_only = tmp_path / "g_only", tmp_path / "do_only"
    g_only.mkdir()
    do_only.mkdir()
    os.link(scan_checkpoint(tmp_path, "g_"), g_only / "g_00000002")
    os.link(scan_checkpoint(tmp_path, "do_"), do_only / "do_00000002")
    for d, gen_from_ckpt, discs_from_ckpt in ((g_only, True, False),
                                              (do_only, False, True)):
        state = new_state(7)
        fresh = new_state(7)
        from speech_inpainting_torch.utils.checkpoints import (
            restore_gan_checkpoint)
        state, had_g, had_do = restore_gan_checkpoint(Checkpointer(d), state)
        assert (had_g, had_do) == (gen_from_ckpt, discs_from_ckpt)
        for module in ("generator", "mpd", "msd"):
            want = getattr(src if (module == "generator") == gen_from_ckpt
                           else fresh, module).state_dict()
            for k, v in getattr(state, module).state_dict().items():
                assert torch.equal(v, want[k]), (d.name, module, k)
        assert state.step == (2 if discs_from_ckpt else 0)
    del ck


def test_step_cap_and_sigterm(tmp_path, capsys):
    capped = run_gan_training(STEP, new_state(), data(10),
                              run_cfg(tmp_path / "cap", training_steps=3))
    assert capped.step == 3
    assert scan_checkpoint(tmp_path / "cap", "g_").endswith("g_00000003")

    def killing(epoch):
        for i, b in enumerate(data(10)(epoch)):
            if i == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            yield b

    before = signal.getsignal(signal.SIGTERM)
    state = run_gan_training(STEP, new_state(), killing,
                             run_cfg(tmp_path / "term",
                                     checkpoint_interval=1000))
    assert signal.getsignal(signal.SIGTERM) is before
    assert 0 < state.step < 10
    assert "preempted: saved g_/do_" in capsys.readouterr().out
    assert scan_checkpoint(tmp_path / "term", "do_").endswith(
        f"do_{state.step:08d}")


def test_nonfinite_abort_saves_first(tmp_path):
    """nan batches from the second on: each update is skipped (the guard),
    and past the budget of 2 the loop saves the still-finite state and
    raises."""
    with pytest.raises(RuntimeError, match="consecutive updates"):
        run_gan_training(STEP, new_state(), data(10, nan_from=1),
                         run_cfg(tmp_path, abort_nonfinite=2,
                                 checkpoint_interval=1000))
    path = scan_checkpoint(tmp_path, "g_")
    assert path.endswith("g_00000004")
    sd = torch.load(path, weights_only=True)["generator"]
    assert all(torch.isfinite(v).all() for v in sd.values())
    do = torch.load(scan_checkpoint(tmp_path, "do_"), weights_only=True)
    assert do["guards"]["g"]["notfinite_count"] == 3


def test_validation_media_and_g_file_serve(tmp_path, monkeypatch):
    rec = {"scalar": [], "audio": [], "mel_figure": []}
    for name in rec:
        orig = getattr(TrainLogger, name)

        def spy(self, tag, value, step, *a, _name=name, _orig=orig):
            rec[_name].append((tag, step))
            return _orig(self, tag, value, step, *a)
        monkeypatch.setattr(TrainLogger, name, spy)
    rng = np.random.default_rng(3)
    val = [{"audio": (rng.standard_normal((2, 1, SEG)) * 0.2).astype(
        np.float32)} for _ in range(2)]
    ev = phg.make_vanilla_eval(PCFG)
    valid = gan_valid_fn(ev, val, media_fwd=phg.vanilla_gen_fwd(PCFG),
                         media_mel=PCFG.mel_input, sample_rate=22050)
    state = run_gan_training(
        STEP, new_state(), data(4),
        run_cfg(tmp_path / "ck", validation_interval=2,
                log_dir=str(tmp_path / "tb")), valid_fn=valid)
    assert rec["scalar"] == [("validation/mel_error", 2),
                             ("validation/mel_error", 4)]
    assert rec["audio"] == [("validation/audio", 2), ("validation/audio", 4)]
    assert rec["mel_figure"] == [("validation/mel", 2), ("validation/mel", 4)]
    assert glob.glob(str(tmp_path / "tb" / "events.*"))
    # the sweep's value is the mean of eval_fn over the batches
    want = np.mean([ev(state.generator, b)["mel_error"] for b in val])
    assert valid(state)["mel_error"] == pytest.approx(want, rel=1e-6)
    served = load_generator_checkpoint(tmp_path / "ck" / "g_00000004",
                                       PCFG.hifigan, device="cpu",
                                       cls=Generator)
    mel = torch.as_tensor(rng.standard_normal((1, 80, 9)).astype(
        np.float32))
    with torch.no_grad():
        assert torch.equal(served(mel), state.generator.fold()(mel))


def test_mesh_is_refused(tmp_path, monkeypatch, group_of_one):
    """What the JAX runner refuses: several processes without a mesh. A
    mesh of one process (a gloo group of one) trains as one device does:
    the same state after two steps."""
    from speech_inpainting_torch.parallel.mesh import make_mesh
    from speech_inpainting_torch.train import run as prun
    monkeypatch.setattr(prun, "world_size", lambda: 2)
    with pytest.raises(RuntimeError, match="multi-process runtime"):
        run_gan_training(STEP, new_state(), data(1),
                         RunConfig(checkpoint_dir=str(tmp_path)))
    monkeypatch.undo()
    plain = run_gan_training(STEP, new_state(), data(2),
                             run_cfg(tmp_path / "plain"))
    meshed = run_gan_training(STEP, new_state(), data(2),
                              run_cfg(tmp_path / "mesh",
                                      mesh=make_mesh(device_type="cpu")))
    assert meshed.step == plain.step == 2 and meshed.mesh is not None
    for (k, a), b in zip(plain.generator.state_dict().items(),
                         meshed.generator.state_dict().values()):
        assert torch.equal(a, b), k
