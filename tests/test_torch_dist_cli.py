"""The three training CLIs as two processes on the CPU, each joined by the
JAX CLIs' own flags (`--coordinator 127.0.0.1:PORT --num-processes 2
--process-id i --device cpu`, gloo), against one process on the same
global batches: both ranks end equal, rank 0 writes the checkpoints, and
the trained module equals the one-process run's within 2·lr·steps (AdamW's
first updates are sign-like where a gradient is near zero: tests/
test_run_mesh.py's bound). The data and configs are those of each CLI's
own test (tiny HuBERT, the GAN CLIs' discriminators cut to one period and
one scale)."""
import dataclasses
import shutil

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from speech_inpainting_torch import testing
from speech_inpainting_torch.cli import train_da, train_ea, train_hifigan
from speech_inpainting_torch.models.hubert import HubertConfig
from test_torch_gan_models import _two_threads  # noqa: F401
from test_torch_train_da_cli import _args as da_args
from test_torch_train_da_cli import corpus  # noqa: F401
from test_torch_train_ea_cli import HUB
from test_torch_train_ea_cli import _args as ea_args
from test_torch_train_hifigan_cli import _args as hifigan_args
from test_torch_train_hifigan_cli import files  # noqa: F401
from torch_dist import launch
from torch_dist_worker import _cut_discs


@pytest.fixture(autouse=True)
def _drop_files(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture
def ea_files(tmp_path, rng):
    """test_torch_train_ea_cli.py's corpus: four 0.2 s utterances, their
    labels and a codebook."""
    wavs = tmp_path / "wavs16"
    wavs.mkdir()
    (tmp_path / "labels").mkdir()
    frames = (3203 - 80) // 320
    for i in range(4):
        wavfile.write(wavs / f"u{i}.wav", 16000,
                      (testing.synthetic_utterance(rng, 0.2) * 32767
                       ).astype(np.int16))
        np.save(tmp_path / "labels" / f"u{i}_labels.npy",
                rng.integers(0, 10, frames).astype(np.int32))
    (tmp_path / "training.txt").write_text("u0\nu1\nu2\nu3\n")
    np.save(tmp_path / "km.npy",
            rng.standard_normal((10, 80)).astype(np.float32))
    return tmp_path


def _compare(outs, one, ckpt, names, tol):
    """Both ranks equal; rank 0's module within `tol` of the one-process
    run's; the checkpoint directory holds `names`."""
    assert outs[0]["step"] == outs[1]["step"] == one.step
    for k, v in outs[0]["params"].items():
        assert torch.equal(outs[1]["params"][k], v), k
    module = one.model if hasattr(one, "model") else one.generator
    for k, v in module.state_dict().items():
        np.testing.assert_allclose(outs[0]["params"][k].numpy(), v.numpy(),
                                   atol=tol, err_msg=k)
    assert sorted(p.name for p in ckpt.iterdir()) == names


def test_train_ea_two_processes(ea_files, tmp_path, monkeypatch):
    d = ea_files
    monkeypatch.setattr(train_ea, "HubertConfig", type("Tiny", (), {
        "base": staticmethod(lambda **o: dataclasses.replace(
            HubertConfig.base(**HUB), **o))}))
    outs = launch("cli", 2, {
        "cli": "train_ea", "hub": HUB,
        "argv": ea_args(d, "dist", "--epochs", "1", "--device", "cpu")},
        tmp_path / "io")
    one = train_ea.main(ea_args(d, "one", "--epochs", "1", "--device",
                                "cpu"))
    _compare(outs, one, d / "dist", ["ea_00000002", "last_00000000"],
             2 * 1e-4 * 2)


def test_train_hifigan_two_processes(files, tmp_path,  # noqa: F811
                                     monkeypatch):
    monkeypatch.setattr(train_hifigan, "default_discriminators", _cut_discs)
    outs = launch("cli", 2, {
        "cli": "train_hifigan", "cut_discs": True,
        "argv": hifigan_args(files, tmp_path / "dist")}, tmp_path / "io")
    one = train_hifigan.main(hifigan_args(files, tmp_path / "one"))
    _compare(outs, one, tmp_path / "dist", ["do_00000002", "g_00000002"],
             2 * 2e-4 * 2)


def test_train_da_two_processes(corpus, tmp_path,  # noqa: F811
                                monkeypatch):
    monkeypatch.setattr(train_da, "default_discriminators", _cut_discs)
    outs = launch("cli", 2, {
        "cli": "train_da", "cut_discs": True,
        "argv": da_args(corpus, tmp_path / "dist")}, tmp_path / "io")
    one = train_da.main(da_args(corpus, tmp_path / "one"))
    _compare(outs, one, tmp_path / "dist", ["do_00000001", "g_00000001"],
             2 * 2e-4 * 1)
