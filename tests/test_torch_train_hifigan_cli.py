"""The port's `train_hifigan` CLI and its CropDataset, on the CPU: the
dataset's batches bit-equal to the JAX package's in its three regimes
(crops, crops with hop-441 mask starts, teacher-mel crops with short
utterances padded); the CLI with a tiny `--config` and `--device cpu` in
the vanilla, modified and teacher-mel regimes (g_/do_ written, the g_
read by `load_generator_checkpoint`), a rerun that resumes 2 → 4,
`--warm-start` from a reference-layout g_ file, `--istft` (the iSTFT-head
generator: 2 steps and a validation sweep, resumed 2 → 4, its g_ loaded
back into `trainable_istft_generator` equal to the trained module), and
the refusals of `--istft` beside `--modified` or `--warm-start` (with the
JAX CLI's reasons), `--mesh` and the distributed flags (naming their
ROADMAP item)."""
import json
import shutil

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from speech_inpainting_tpu.cli.train_hifigan import CropDataset as JaxCrops
from speech_inpainting_torch import testing
from speech_inpainting_torch.cli import train_hifigan
from speech_inpainting_torch.cli.train_hifigan import CropDataset
from speech_inpainting_torch.convert.from_jax import generator_tree
from speech_inpainting_torch.convert.hifigan_torch import (
    load_generator_checkpoint)
from speech_inpainting_torch.models.hifigan import Generator, HiFiGANConfig
from test_torch_gan_models import _two_threads  # noqa: F401


CONFIG = {"resblock": "1", "upsample_rates": [8, 8, 4],
          "upsample_kernel_sizes": [16, 16, 8],
          "upsample_initial_channel": 16, "resblock_kernel_sizes": [3],
          "resblock_dilation_sizes": [[1, 3]], "num_mels": 80,
          "sampling_rate": 22050, "segment_size": 4096}
GCFG = HiFiGANConfig.from_dict(CONFIG)


@pytest.fixture(autouse=True)
def _drop_files(tmp_path):
    """Each test's checkpoints go with it: a do_ file holds the
    discriminators and both optimizers' moments (up to 1 GB)."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("hifigan")
    rng = np.random.default_rng(11)
    (d / "wavs").mkdir()
    (d / "mels").mkdir()
    names = [f"utt{i}" for i in range(5)]
    lengths = [11025, 9000, 12000, 3000, 10000]   # utt3 shorter than a crop
    for n, length in zip(names, lengths):
        wav = rng.standard_normal(length) * 0.2
        wavfile.write(d / "wavs" / f"{n}.wav", 22050,
                      (np.clip(wav, -1, 1) * 32767).astype(np.int16))
        np.save(d / "mels" / f"{n}.npy", rng.standard_normal(
            (1, 80, length // 256 + 1)).astype(np.float32))
    (d / "train.txt").write_text("\n".join(f"{n}|text" for n in names[:4]))
    (d / "valid.txt").write_text(names[4] + "\n")
    (d / "config.json").write_text(json.dumps(CONFIG))
    np.save(d / "km.npy", rng.standard_normal((10, 80)).astype(np.float32))
    return d


@pytest.mark.parametrize("regime", ["crops", "mask_starts", "teacher"])
def test_crop_batches_equal_jax(files, regime):
    paths = sorted((files / "wavs").glob("*.wav"))
    kw = dict(normalize=False, mels_dir=files / "mels", hop=256) \
        if regime == "teacher" else {}
    limit = 7 if regime == "mask_starts" else 0
    ours, theirs = CropDataset(paths, 4096, **kw), JaxCrops(paths, 4096,
                                                            **kw)
    for epoch in (0, 3):
        a = list(ours.batches(2, epoch=epoch, seed=5, n441_mask_limit=limit))
        b = list(theirs.batches(2, epoch=epoch, seed=5,
                                n441_mask_limit=limit))
        assert len(a) == len(b) == 2
        for x, y in zip(a, b):
            assert x.keys() == y.keys()
            for k in x:
                assert x[k].dtype == y[k].dtype
                np.testing.assert_array_equal(x[k], y[k])


def _args(files, ckpt, *extra):
    return ["--wavs", str(files / "wavs"), "--filelist",
            str(files / "train.txt"), "--config", str(files / "config.json"),
            "--checkpoint-path", str(ckpt), "--batch-size", "2",
            "--epochs", "1", "--device", "cpu", *extra]


def _served_equals_fold(ckpt, step, state):
    served = load_generator_checkpoint(ckpt / f"g_{step:08d}", GCFG,
                                       device="cpu", cls=Generator)
    mel = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (1, 80, 6)).astype(np.float32))
    with torch.no_grad():
        return torch.equal(served(mel), state.generator.fold()(mel))


def test_cli_vanilla_and_resume(files, tmp_path, capsys):
    ckpt = tmp_path / "ck"
    first = train_hifigan.main(_args(files, ckpt))
    assert first.step == 2
    assert sorted(p.name for p in ckpt.iterdir()) == ["do_00000002",
                                                      "g_00000002"]
    second = train_hifigan.main(_args(files, ckpt))
    assert "resumed from step 2" in capsys.readouterr().out
    assert second.step == 4
    assert _served_equals_fold(ckpt, 4, second)


def test_cli_modified_with_validation(files, tmp_path, capsys):
    ckpt = tmp_path / "ck"
    state = train_hifigan.main(_args(
        files, ckpt, "--modified", "--kmeans", str(files / "km.npy"),
        "--mask-len", "2", "--valid-filelist", str(files / "valid.txt"),
        "--validation-interval", "1", "--skip-nonfinite", "3"))
    assert state.step == 2 and state.g_guard is not None
    assert _served_equals_fold(ckpt, 2, state)


def test_cli_teacher_mels_and_warm_start(files, tmp_path, capsys):
    rng = np.random.default_rng(4)
    tree = testing.generator_tree(GCFG, rng)
    torch.save({"generator": testing.generator_state_dict(tree, GCFG)},
               tmp_path / "g_ref")
    state = train_hifigan.main(_args(
        files, tmp_path / "ck", "--fine-tuning", "--input-mels-dir",
        str(files / "mels"), "--warm-start", str(tmp_path / "g_ref")))
    assert "warm-started generator from" in capsys.readouterr().out
    assert state.step == 2
    # two AdamW updates moved the imported weights by at most
    # lr·(1.01 + wd·|p|) each (|m̂|/√v̂ ≤ 1.005 at the second, b1 0.8,
    # b2 0.99)
    pairs = zip(_paths(generator_tree(state.generator)), _paths(tree))
    for a, b in pairs:
        assert np.abs(a - b).max() <= 2 * 2e-4 * (1.01
                                                 + 0.01 * np.abs(b).max())


def _paths(tree, out=None):
    out = [] if out is None else out
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            _paths(tree[k], out)
        else:
            out.append(tree[k])
    return out


def test_cli_istft_with_validation_and_resume(files, tmp_path, capsys,
                                              monkeypatch):
    from speech_inpainting_torch.convert.from_jax import (
        trainable_istft_generator)
    from speech_inpainting_torch.models.hifigan_istft import (
        ISTFTGenerator, ISTFTGeneratorConfig, WNISTFTGenerator)
    folds = []
    fold = WNISTFTGenerator.fold
    monkeypatch.setattr(WNISTFTGenerator, "fold",
                        lambda self: folds.append(1) or fold(self))
    ckpt = tmp_path / "ck"
    args = _args(files, ckpt, "--istft", "--valid-filelist",
                 str(files / "valid.txt"), "--validation-interval", "2")
    first = train_hifigan.main(args)
    assert isinstance(first.generator, WNISTFTGenerator)
    assert first.step == 2
    second = train_hifigan.main(args)
    assert "resumed from step 2" in capsys.readouterr().out
    assert second.step == 4
    assert len(folds) == 2          # one validation sweep in each run
    assert sorted(p.name for p in ckpt.iterdir()) == [
        "do_00000002", "do_00000004", "g_00000002", "g_00000004"]
    # the C8C8I trunk at the config's width, kernel sizes and dilations
    icfg = ISTFTGeneratorConfig(upsample_initial_channel=16,
                                resblock_kernel_sizes=(3,),
                                resblock_dilation_sizes=((1, 3),))
    assert second.generator.istft == icfg
    loaded = trainable_istft_generator(icfg, device="cpu")
    loaded.load_state_dict(torch.load(ckpt / "g_00000004",
                                      weights_only=True)["generator"])
    for (n, a), (m, b) in zip(loaded.state_dict().items(),
                              second.generator.state_dict().items()):
        assert n == m and torch.equal(a, b), n
    folded = loaded.fold()
    assert isinstance(folded, ISTFTGenerator)
    mel = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (1, 80, 6)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(folded(mel), second.generator.fold()(mel))


@pytest.mark.parametrize("flags,item", [
    (["--istft", "--modified", "--kmeans", "k.npy"], "vanilla-recipe"),
    (["--istft", "--warm-start", "g_00000001"], "trains fresh"),
    (["--mesh"], "item 11"),
    (["--coordinator", "localhost:1"], "item 11"),
    (["--num-processes", "2"], "item 11"),
    (["--process-id", "0"], "item 11")])
def test_cli_refusals(files, tmp_path, capsys, flags, item):
    with pytest.raises(SystemExit):
        train_hifigan.main(_args(files, tmp_path, *flags))
    assert item in capsys.readouterr().err


def test_cli_needs_its_inputs(files, tmp_path, capsys):
    for flags in (["--modified"], ["--fine-tuning"],
                  ["--fine-tuning", "--modified", "--input-mels-dir", "m"]):
        with pytest.raises(SystemExit):
            train_hifigan.main(_args(files, tmp_path, *flags))
