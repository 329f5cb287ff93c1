"""The pitch quantizer's training CLI (cli/train_f0vq.py) beside the JAX
package's, on the CPU, over four synthetic 16 kHz wavs at small widths;
then its `g_` into a CodeGenerator's `fo_vqvae`
(convert/ida_torch.py:load_f0_quantizer), as `train_da --f0-quantizer DIR`
restores it.

The two CLIs draw their own inits (JAX's PRNG, the port's CPU generator),
so their numbers are not compared; what they share is held: the flags and
the config keys, the steps a run takes, the checkpoint names, the resume
(the step count restored, the epoch loop and the candidates' generator
from the start again). The port's run is held exactly against its own
loop over the same batches (train/f0vq.py's step, itself held against
JAX's step in tests/test_torch_f0vq.py), and the loaded quantizer's units
equal the trained model's.
"""
import json

import numpy as np
import pytest
import torch

from speech_inpainting_tpu.cli import train_f0vq as jcli
from speech_inpainting_torch import testing
from speech_inpainting_torch.cli import train_f0vq as pcli
from speech_inpainting_torch.convert.from_jax import (codegen_from_jax,
                                                      trainable_fo_vqvae)
from speech_inpainting_torch.convert.ida_torch import (
    load_f0_quantizer, load_f0vq_training_checkpoint)
from speech_inpainting_torch.data.audio import save_wav
from speech_inpainting_torch.data.code_dataset import F0DatasetTPU
from speech_inpainting_torch.models.codegen import (CodeGeneratorConfig,
                                                    FoVQVAEConfig)
from speech_inpainting_torch.models.hifigan import HiFiGANConfig
from speech_inpainting_torch.train import f0vq

STACK = {"input_emb_width": 1, "output_emb_width": 16, "levels": 1,
         "downs_t": [2], "strides_t": [2], "width": 8, "depth": 2,
         "m_conv": 1.0, "dilation_growth_rate": 3}
CONFIG = {"segment_size": 8960, "f0_vq_params": {"l_bins": 8,
                                                 "emb_width": 16, "mu": 0.99,
                                                 "levels": 1},
          "f0_encoder_params": STACK, "f0_decoder_params": STACK,
          "lambda_commit": 0.02, "learning_rate": 0.0002, "adam_b1": 0.8,
          "adam_b2": 0.99, "lr_decay": 0.999, "batch_size": 2}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("f0vq")
    rng = np.random.default_rng(9)
    files = []
    for i, s in enumerate((1.2, 1.25, 1.3, 1.35)):
        path = root / f"spk{i % 2}_{i:03d}.wav"
        save_wav(path, testing.synthetic_utterance(rng, s), 16000)
        files.append(path)
    (root / "train.txt").write_text("\n".join(map(str, files)) + "\n")
    (root / "f0_vqvae.json").write_text(json.dumps(CONFIG))
    return root


def _argv(root, ckpt):
    return ["--config", str(root / "f0_vqvae.json"), "--train-manifest",
            str(root / "train.txt"), "--checkpoint-path", str(ckpt),
            "--epochs", "1", "--seed", "3"]


def test_train_resume_and_load_into_the_generator(corpus, tmp_path,
                                                   capsys):
    ckpt = tmp_path / "port"
    first = pcli.main(_argv(corpus, ckpt) + ["--device", "cpu"])
    assert first.step == 2
    assert sorted(p.name for p in ckpt.iterdir()) == ["g_00000002"]
    second = pcli.main(_argv(corpus, ckpt) + ["--device", "cpu"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert second.step == 4
    assert sorted(p.name for p in ckpt.iterdir()) == ["g_00000002",
                                                      "g_00000004"]
    saved = torch.load(ckpt / "g_00000004", weights_only=True)
    assert sorted(saved) == ["opt", "params", "steps", "vq"]
    assert saved["steps"] == 4
    assert sorted(saved["vq"]) == [f"vq.level_0.{k}" for k in (
        "initted", "k", "k_elem", "k_sum")]
    assert {s["step"] for s in saved["opt"]["state"].values()} == {4}

    # the JAX CLI, same flags and config: the same steps and names
    jckpt = tmp_path / "jax"
    jcli.main(_argv(corpus, jckpt))
    jcli.main(_argv(corpus, jckpt))
    assert "resumed from step 2" in capsys.readouterr().out
    assert sorted(p.name for p in jckpt.iterdir()
                  if p.name.startswith("g_")) == ["g_00000002", "g_00000004"]

    # the CLI's two runs are its loop: a fresh init from the seed, two
    # steps of epoch 0, then resumed, epoch 0 again with the generator
    # restarted
    cfg = FoVQVAEConfig.from_dict(CONFIG)
    tcfg = f0vq.F0VQConfig(model=cfg)
    ds = F0DatasetTPU((corpus / "train.txt").read_text().split(),
                      segment_size=8960, device="cpu")
    state = f0vq.create_f0vq_state(tcfg, trainable_fo_vqvae(
        cfg, seed=3, device="cpu"))
    step = f0vq.make_f0vq_step(tcfg, device="cpu")
    for _ in range(2):
        gen = torch.Generator().manual_seed(5)
        for batch in ds.batches(2, epoch=0, seed=3):
            state, _ = step(state, batch, gen)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, second.model.state_dict()[k]), k

    # item 13: the directory into a CodeGenerator's pitch quantizer
    trained = load_f0vq_training_checkpoint(ckpt, cfg, device="cpu")
    for k, v in trained.state_dict().items():
        assert torch.equal(v, second.model.state_dict()[k]), k
    hcfg = HiFiGANConfig(upsample_rates=(4, 4, 4, 5),
                         upsample_kernel_sizes=(8, 8, 8, 11),
                         upsample_initial_channel=32,
                         resblock_kernel_sizes=(3,),
                         resblock_dilation_sizes=((1, 3, 5),),
                         in_dim=24, sampling_rate=16000)
    ccfg = CodeGeneratorConfig(hcfg, num_embeddings=10, embedding_dim=8,
                               multispkr=True, f0_quantizer=cfg)
    params, vq = testing.codegen_tree(ccfg, np.random.default_rng(0))
    codegen = load_f0_quantizer(ckpt, codegen_from_jax(ccfg, params, vq,
                                                       device="cpu"))
    assert not any(p.requires_grad for p in codegen.parameters())
    f0 = torch.tensor(next(ds.batches(2, epoch=1, seed=0))["f0"])
    with torch.no_grad():
        np.testing.assert_array_equal(
            codegen.fo_vqvae.encode_units(f0).numpy(),
            second.model.encode_units(f0).numpy())
        wav = codegen(torch.randint(0, 10, (2, 28)), f0,
                      emb=torch.randn(2, 8))
    assert wav.shape == (2, 1, 8960) and torch.isfinite(wav).all()
    # a reference-layout file takes the file branch
    ref = tmp_path / "g_ref"
    torch.save({"generator": testing.fo_vqvae_state_dict(
        *testing.fo_vqvae_tree(cfg, np.random.default_rng(1)), cfg)}, ref)
    load_f0_quantizer(ref, codegen)
    assert not torch.equal(codegen.fo_vqvae.vq.level_0.k,
                           trained.vq.level_0.k)
