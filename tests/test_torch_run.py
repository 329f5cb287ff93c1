"""The port's I_ea training loop (train/run.py), its checkpoints
(utils/checkpoints.py), logger (utils/logging.py) and prefetch
(data/pipeline.py), on the CPU: tests/test_run.py's EA cases with a stub
step (`best_`/`last_`, full-state resume), a SIGTERM mid-epoch that saves
and returns, the nonfinite abort, and both packages' loops over the same
EADataset for 4 steps (TINY HuBERT, the same tree): final parameters
within 1e-5 (but the zero-gradient k_proj bias, which moves by rounding
noise on each side), and the stdout lines equal but for their s/b
timings."""
import os
import re
import signal

import numpy as np
import pytest
import torch

import jax

from speech_inpainting_tpu.data.ea_dataset import EADataset as JaxDataset
from speech_inpainting_tpu.models.hubert import EncoderWithHead as JaxModel
from speech_inpainting_tpu.models.hubert import HubertConfig as JaxConfig
from speech_inpainting_tpu.train import ea as jea
from speech_inpainting_tpu.train import run as jrun
from speech_inpainting_torch.convert.from_jax import (hubert_tree,
                                                      trainable_hubert)
from speech_inpainting_torch.data.audio import save_wav
from speech_inpainting_torch.data.ea_dataset import EADataset
from speech_inpainting_torch.data.pipeline import device_prefetch
from speech_inpainting_torch.models.hubert import HubertConfig
from speech_inpainting_torch.train import ea as pea
from speech_inpainting_torch.train.run import RunConfig, run_ea_training
from speech_inpainting_torch.utils.checkpoints import (Checkpointer,
                                                       checkpoint_step,
                                                       scan_checkpoint)
from test_torch_train_ea import NOISE, TINY, assert_trees, setup
from torch_dist import group_of_one  # noqa: F401


class Stub:
    """A train state with a step, a model (whose device the loop reads)
    and one optimizer-like tensor."""

    def __init__(self):
        self.step = 0
        self.model = torch.nn.Linear(2, 1)
        self.m = torch.zeros(2)

    def state_dict(self):
        return {"step": self.step, "model": self.model.state_dict(),
                "m": self.m}

    def load_state_dict(self, sd):
        self.step = sd["step"]
        self.model.load_state_dict(sd["model"])
        self.m = sd["m"].clone()


def stub_step(state, batch):
    state.step += 1
    with torch.no_grad():
        state.model.bias += batch["x"].sum()
    state.m = state.m + 1.0
    return state, {"loss": torch.tensor(1.0)}


def batches(n):
    return lambda epoch: iter([{"x": np.full((1,), 1.0, np.float32)}
                               for _ in range(n)])


def test_best_and_last_checkpoints(tmp_path):
    accs = iter([0.1, 0.9, 0.5, 0.2])
    seen = []

    def ev(model, vb):
        seen.append(float(model.bias.detach()))
        return {"cos_sim_acc": next(accs), "loss": 0.0}

    run = RunConfig(epochs=1, checkpoint_dir=str(tmp_path),
                    validation_interval=2, stdout_interval=100)
    state = Stub()
    b0 = float(state.model.bias.detach())
    run_ea_training(stub_step, ev, state, batches(8),
                    lambda epoch: iter([{"x": np.zeros(1)}]), run)
    assert {"best_00000000", "last_00000000",
            "ea_00000008"} <= {p.name for p in tmp_path.iterdir()}
    ck = Checkpointer(tmp_path)
    # best_ holds the model of the highest cos_sim_acc (step 4)
    np.testing.assert_allclose(
        float(ck.restore("best_")["model"]["bias"]), seen[1])
    np.testing.assert_allclose(float(ck.restore("last_")["model"]["bias"]),
                               b0 + 8)
    assert scan_checkpoint(tmp_path, "ea_").endswith("ea_00000008")
    assert checkpoint_step(scan_checkpoint(tmp_path, "ea_")) == 8
    assert scan_checkpoint(tmp_path / "absent", "ea_") is None


def test_full_state_resume(tmp_path):
    run = RunConfig(epochs=1, checkpoint_dir=str(tmp_path),
                    validation_interval=1000, stdout_interval=100)
    ev = lambda model, vb: {"cos_sim_acc": 0.0}  # noqa: E731
    s1 = run_ea_training(stub_step, ev, Stub(), batches(4),
                         lambda e: iter([]), run)
    assert s1.step == 4
    s2 = run_ea_training(stub_step, ev, Stub(), batches(3),
                         lambda e: iter([]), run)
    assert s2.step == 7
    np.testing.assert_allclose(s2.m.numpy(), np.zeros(2) + 7)
    np.testing.assert_allclose(float(s2.model.bias.detach()),
                               float(s1.model.bias.detach()) + 3, rtol=1e-6)


def test_sigterm_saves_and_resumes(tmp_path):
    """SIGTERM mid-epoch: the loop saves ea_ and returns; a rerun resumes
    losslessly, with the caller's handler back in place."""
    def killing(epoch):
        for i in range(10):
            if i == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            yield {"x": np.full((1,), 1.0, np.float32)}

    before = signal.getsignal(signal.SIGTERM)
    run = RunConfig(epochs=1, checkpoint_dir=str(tmp_path),
                    checkpoint_interval=1000, validation_interval=1000,
                    stdout_interval=100)
    ev = lambda model, vb: {}  # noqa: E731
    state = run_ea_training(stub_step, ev, Stub(), killing,
                            lambda e: iter([]), run)
    assert signal.getsignal(signal.SIGTERM) is before
    s_pre = state.step
    assert 0 < s_pre < 10
    assert scan_checkpoint(tmp_path, "ea_").endswith(f"ea_{s_pre:08d}")
    state2 = run_ea_training(stub_step, ev, Stub(), batches(10),
                             lambda e: iter([]), run)
    assert state2.step == s_pre + 10
    np.testing.assert_allclose(state2.m.numpy(), np.zeros(2) + s_pre + 10)


def test_abort_nonfinite(tmp_path):
    def nan_step(state, batch):
        state, m = stub_step(state, batch)
        m["nonfinite_skips"] = state.step      # an ever-growing streak
        return state, m

    run = RunConfig(epochs=1, checkpoint_dir=str(tmp_path),
                    stdout_interval=1, abort_nonfinite=2)
    with pytest.raises(RuntimeError, match="consecutive updates"):
        run_ea_training(nan_step, lambda m, b: {}, Stub(), batches(10),
                        lambda e: iter([]), run)
    assert scan_checkpoint(tmp_path, "ea_").endswith("ea_00000003")


def test_mesh_is_refused(tmp_path, monkeypatch, group_of_one):
    """What the JAX runner refuses: several processes without a mesh (each
    would train a model of its own, no gradient reduction). A mesh of one
    process (a gloo group of one) runs the steps on it, as one device
    does."""
    from speech_inpainting_torch.parallel.mesh import make_mesh
    from speech_inpainting_torch.train import run as prun
    monkeypatch.setattr(prun, "world_size", lambda: 2)
    with pytest.raises(RuntimeError, match="multi-process runtime"):
        run_ea_training(stub_step, None, Stub(), batches(1), None,
                        RunConfig(checkpoint_dir=str(tmp_path)))
    monkeypatch.undo()
    mesh = make_mesh(device_type="cpu")
    stub = Stub()
    bias = float(stub.model.bias.detach())
    state = run_ea_training(stub_step, lambda m, b: {}, stub, batches(2),
                            lambda e: iter([]),
                            RunConfig(epochs=1, checkpoint_dir=str(tmp_path),
                                      stdout_interval=100, mesh=mesh))
    assert state.mesh is mesh and state.step == 2
    assert float(state.model.bias.detach()) == pytest.approx(bias + 2.0)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ea_00000002", "last_00000000"]


def test_prefetch_passes_loader_errors(rng):
    def broken():
        yield {"x": np.zeros(2, np.float32)}
        raise ValueError("bad file")

    it = device_prefetch(broken(), device="cpu")
    assert torch.equal(next(it)["x"], torch.zeros(2))
    with pytest.raises(ValueError, match="bad file"):
        next(it)


def test_checkpoint_writes_are_atomic_and_async(tmp_path):
    ck = Checkpointer(tmp_path)
    t = torch.arange(4.0)
    path = ck.save("ea_", 3, {"t": t})
    t += 10                     # after save returns: not in the file
    ck.wait()
    assert torch.equal(torch.load(path)["t"], torch.arange(4.0))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ea_00000003"]
    with pytest.raises(Exception):
        ck.save("ea_", 4, {"f": lambda: 0}, wait=True)   # unpicklable
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ea_00000003"]
    assert ck.restore("ea_")["t"].tolist() == [0.0, 1.0, 2.0, 3.0]


def _corpus(tmp_path, rng, n=4):
    paths, labels = [], []
    for i in range(n):
        p = tmp_path / f"u{i}.wav"
        save_wav(p, (rng.standard_normal(3000 + 200 * i) * 0.2
                     ).astype(np.float32), 16000)
        paths.append(p)
        labels.append(rng.integers(0, 10, 9))
    return paths, labels


def _lines(text):
    return [re.sub(r", s/b: [0-9.]+", "", l) for l in text.splitlines()
            if l.startswith("Steps:")]


def test_loop_matches_jax_loop(tmp_path, rng, capsys):
    """Both loops over the same dataset, 2 epochs of 2 batches."""
    tree, centroids, out_dim, over = setup(rng)
    paths, labels = _corpus(tmp_path, rng)
    kw = dict(max_length=3203, mask_length=3)
    jds, pds = JaxDataset(paths, labels, **kw), EADataset(paths, labels, **kw)
    cfg = jea.EAConfig(**over)
    jmodel = JaxModel(JaxConfig(**TINY), out_dim=out_dim)
    js = jrun.run_ea_training(
        jea.make_train_step(jmodel, cfg, centroids),
        jea.eval_step(jmodel, cfg, centroids),
        jea.create_state(cfg, jax.tree.map(np.asarray, tree)),
        lambda e: jds.batches(2, epoch=e), lambda e: jds.batches(2),
        jrun.RunConfig(epochs=2, checkpoint_dir=str(tmp_path / "jax"),
                       stdout_interval=1, validation_interval=2))
    jout = _lines(capsys.readouterr().out)
    pcfg = pea.EAConfig(**over)
    model = trainable_hubert(HubertConfig(**TINY), tree, out_dim,
                             device="cpu")
    ps = run_ea_training(
        pea.make_train_step(pcfg, centroids, "cpu"),
        pea.eval_step(pcfg, centroids, "cpu"),
        pea.create_state(pcfg, model),
        lambda e: pds.batches(2, epoch=e), lambda e: pds.batches(2),
        RunConfig(epochs=2, checkpoint_dir=str(tmp_path / "port"),
                  stdout_interval=1, validation_interval=2))
    pout = _lines(capsys.readouterr().out)
    assert len(pout) == 4 and pout == jout
    assert ps.step == int(js.step) == 4
    # the zero-gradient k_proj bias moves by noise (test_torch_train_ea.py)
    assert_trees(js.params, hubert_tree(ps.model), 0, 1e-5, "params",
                 skip=NOISE)
    assert {p.name for p in (tmp_path / "port").iterdir()} == {
        "best_00000000", "last_00000000", "ea_00000004"}
