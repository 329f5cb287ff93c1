"""The port stands apart from JAX, the JAX package and transformers (it
reads HF-layout state dicts as they are), builds its
kernels by nvcc + ctypes only, never falls back to the CPU unasked, and pins
full float32 (no TF32) inside its entry points without touching the
caller's flags."""
import ast
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_dist import group_of_one  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "speech_inpainting_torch"
BANNED = ("jax", "jaxlib", "flax", "speech_inpainting_tpu", "transformers",
          "optax", "orbax", "safetensors")


def _port_modules():
    return sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  .removesuffix(".__init__") for p in PORT.rglob("*.py"))


def test_every_module_imports_with_jax_blocked():
    assert {"speech_inpainting_torch.train.da",
            "speech_inpainting_torch.cli.train_da",
            "speech_inpainting_torch.infer.aot",
            "speech_inpainting_torch.cli.export_aot",
            "speech_inpainting_torch.ops.int8",
            "speech_inpainting_torch.utils.timing",
            "speech_inpainting_torch.utils.profiling",
            "speech_inpainting_torch.utils.config",
            "speech_inpainting_torch.data.download",
            "speech_inpainting_torch.parallel.mesh",
            "speech_inpainting_torch.parallel.distributed",
            "speech_inpainting_torch.parallel.tp"} <= set(_port_modules())
    blocked = "".join(f"sys.modules[{b!r}] = None\n" for b in BANNED)
    code = (f"import sys\n{blocked}import importlib, pickle\n"
            f"for m in {_port_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            # the JAX package's numpy pickles load and convert without JAX
            "from speech_inpainting_torch.convert.from_jax import "
            "generator_from_jax\n"
            "from speech_inpainting_torch.models.hifigan import HiFiGANConfig\n"
            "tree = pickle.load(open('eval_r5/hifigan_v1_g.pkl', 'rb'))\n"
            "cfg = HiFiGANConfig(upsample_rates=(8, 8, 4), "
            "upsample_kernel_sizes=(16, 16, 8), upsample_initial_channel=192,"
            " resblock_kernel_sizes=(3, 7), resblock_dilation_sizes=((1, 3, "
            "5), (1, 3, 5)))\n"
            "generator_from_jax(cfg, tree, device='cpu')\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


# Whisper's WER/CER column needs `transformers` where a local model cache
# exists: metrics/asr.py may import it, inside its functions only (so that
# importing the module never does, and `available()` is False without it)
LAZY = {PORT / "metrics" / "asr.py": {"transformers"}}


# the multi-rank tests' workers run the port alone, as chip_smoke.py does
WORKERS = [ROOT / "tests" / "torch_dist_worker.py",
           ROOT / "tests" / "torch_dist.py"]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"] + WORKERS,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    tree = ast.parse(path.read_text())
    lazy = LAZY.get(path, set())
    functions = [node for node in ast.walk(tree)
                 if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))]
    inner = [name for f in functions for stmt in f.body
             for name in _imported(stmt)]
    for name in inner:
        if name.split(".")[0] not in lazy:
            assert name.split(".")[0] not in BANNED, f"{path} imports {name}"
    # every import outside a function body, the allowed packages included
    for fn in functions:
        fn.body = []
    for name in _imported(tree):
        assert name.split(".")[0] not in BANNED, f"{path} imports {name}"


def test_kernels_are_plain_cuda_built_by_nvcc():
    for path in list(PORT.rglob("*.cu")) + list(PORT.rglob("*.cuh")):
        assert not re.search(r'#include\s*[<"](torch|ATen|c10)/',
                             path.read_text()), path
    for path in list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        assert "cpp_extension" not in path.read_text(), path
    from speech_inpainting_torch.kernels import build
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert sorted(p.name for p in build.CSRC_DIR.iterdir()) == [
        "resblock1.cu"]
    # built output lands in a directory that .gitignore lists
    assert build.BUILD_DIR.relative_to(ROOT).parts[0] == "build"
    assert "build/" in (ROOT / ".gitignore").read_text().splitlines()


def test_entry_points_refuse_the_cpu_unasked(group_of_one):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    from speech_inpainting_torch import resolve_device
    from speech_inpainting_torch.convert.from_jax import (
        codegen_from_jax, generator_from_jax, hubert_model_from_jax,
        istft_generator_from_jax)
    from speech_inpainting_torch.convert.hifigan_torch import (
        convert_generator)
    from speech_inpainting_torch.convert.hubert_torch import (
        convert_custom_model, convert_fairseq_hubert, convert_hf_hubert,
        load_hf_pretrained)
    from speech_inpainting_torch.convert.ida_torch import (
        convert_code_generator, convert_fo_vqvae)
    from speech_inpainting_torch.convert.from_jax import (fo_vqvae_from_jax,
                                                          trainable_hubert)
    from speech_inpainting_torch.cli import train_ea, train_hifigan
    from speech_inpainting_torch.convert.from_jax import (
        mpd_from_jax, msd_from_jax, trainable_generator)
    from speech_inpainting_torch.convert.hifigan_torch import (
        convert_mpd, convert_msd, load_discriminator_checkpoint,
        load_trainable_generator)
    from speech_inpainting_torch.train.gan import (GANConfig,
                                                   default_discriminators)
    from speech_inpainting_torch.data.code_dataset import mel_stats_embedder
    from speech_inpainting_torch.models.codegen import FoVQVAEConfig
    from speech_inpainting_torch.quantize.kmeans import fit_kmeans
    from speech_inpainting_torch.models.hifigan_istft import (
        ISTFTGeneratorConfig)
    from speech_inpainting_torch.infer.ida_inpaint import IdaInpainter
    from speech_inpainting_torch.infer.inpaint import (InformedInpainter,
                                                       InpainterConfig)
    from speech_inpainting_torch.infer.resynth import Resynthesizer
    from speech_inpainting_torch.models.codegen import CodeGeneratorConfig
    from speech_inpainting_torch.models.hifigan import HiFiGANConfig
    from speech_inpainting_torch.models.hubert import HubertConfig
    from speech_inpainting_torch.cli import prep, train_f0vq
    from speech_inpainting_torch.convert.from_jax import trainable_fo_vqvae
    from speech_inpainting_torch.convert.ida_torch import (
        load_f0vq_training_checkpoint)
    from speech_inpainting_torch.data.code_dataset import (
        CodeDataset, F0DatasetTPU, _extract_f0_bucketed)
    from speech_inpainting_torch.data.wav2mel import Wav2Mel
    from speech_inpainting_torch.ops.f0 import F0Config
    from speech_inpainting_torch.train.f0vq import (F0VQConfig,
                                                    make_f0vq_eval,
                                                    make_f0vq_step)
    from speech_inpainting_torch.cli import train_da
    from speech_inpainting_torch.convert.from_jax import trainable_codegen
    from speech_inpainting_torch.cli import predict_asr, score
    from speech_inpainting_torch.data.code_dataset import (
        torchscript_embedder)
    from speech_inpainting_torch.metrics.asr import WhisperScorer
    from speech_inpainting_torch.cli import export_aot
    from speech_inpainting_torch.infer.aot import (export_serving_graph,
                                                   load_serving_artifact,
                                                   save_serving_artifact)
    from speech_inpainting_torch.models.hubert import (
        extract_features_chunked)
    from speech_inpainting_torch.convert.from_jax import (
        trainable_istft_generator)
    from speech_inpainting_torch.parallel.distributed import make_hybrid_mesh
    from speech_inpainting_torch.parallel.mesh import make_mesh
    cpu_mesh = make_mesh(device_type="cpu")
    assert resolve_device("cpu").type == "cpu"
    cg = CodeGeneratorConfig(HiFiGANConfig(), use_f0=False)
    for call in (lambda: resolve_device(),
                 lambda: generator_from_jax(HiFiGANConfig(), {}),
                 lambda: InformedInpainter(
                     InpainterConfig(HubertConfig.base(), HiFiGANConfig()),
                     {}, {}, np.zeros((3, 80), np.float32)),
                 lambda: codegen_from_jax(cg, {}, {}),
                 lambda: hubert_model_from_jax(HubertConfig.base(), {}),
                 lambda: Resynthesizer(cg, {}, {}),
                 lambda: IdaInpainter(cg, {}, {}, HubertConfig.base(), {},
                                      np.zeros((3, 768), np.float32)),
                 lambda: istft_generator_from_jax(ISTFTGeneratorConfig(), {}),
                 lambda: convert_generator({}, HiFiGANConfig()),
                 lambda: convert_custom_model({}, HubertConfig.large()),
                 lambda: convert_hf_hubert({}, HubertConfig.large()),
                 lambda: convert_fairseq_hubert({}, HubertConfig.base()),
                 lambda: load_hf_pretrained("."),
                 lambda: convert_code_generator({}, cg),
                 lambda: convert_fo_vqvae({}, FoVQVAEConfig()),
                 lambda: fo_vqvae_from_jax(FoVQVAEConfig(), {}, {}),
                 lambda: mel_stats_embedder(),
                 lambda: fit_kmeans(np.zeros((4, 2), np.float32), 2),
                 lambda: trainable_hubert(HubertConfig.base(), None),
                 lambda: train_ea.main(["--wavs", ".", "--split", "s",
                                        "--labels-dir", ".", "--kmeans", "k",
                                        "--checkpoint-path", "c"]),
                 lambda: trainable_generator(HiFiGANConfig()),
                 lambda: mpd_from_jax(),
                 lambda: msd_from_jax(),
                 lambda: convert_mpd({}),
                 lambda: convert_msd({}),
                 lambda: load_discriminator_checkpoint("do_00000001"),
                 lambda: load_trainable_generator("g_00000001",
                                                  HiFiGANConfig()),
                 lambda: default_discriminators(GANConfig()),
                 lambda: train_hifigan.main(["--wavs", ".",
                                             "--checkpoint-path", "c"]),
                 lambda: trainable_fo_vqvae(FoVQVAEConfig()),
                 lambda: make_f0vq_step(F0VQConfig()),
                 lambda: make_f0vq_eval(F0VQConfig()),
                 lambda: load_f0vq_training_checkpoint(".", FoVQVAEConfig()),
                 lambda: F0DatasetTPU([]),
                 lambda: CodeDataset([], []),
                 lambda: _extract_f0_bucketed(np.zeros(8), F0Config()),
                 lambda: Wav2Mel(),
                 lambda: train_f0vq.main(["--config", "c", "--train-manifest",
                                          "m", "--checkpoint-path", "c"]),
                 lambda: prep.main(["f0-stats", "--manifest", "m", "--out",
                                    "o"]),
                 lambda: prep.main(["quantize", "--manifest", "m",
                                    "--hubert", "h", "--kmeans", "k.npy",
                                    "--out", "o"]),
                 lambda: trainable_codegen(cg),
                 lambda: train_da.main(["--config", "c", "--train-manifest",
                                        "m", "--checkpoint-path", "c"]),
                 lambda: torchscript_embedder("w", "e"),
                 lambda: WhisperScorer(),
                 lambda: score.main(["--ref", "r", "--deg", "d"]),
                 lambda: predict_asr.main([
                     "--input", "m", "--mask", "0.2:0.4", "--donor", "d",
                     "--config", "c", "--codegen-checkpoint", "g",
                     "--hubert", "h", "--kmeans", "k", "--out", "o"]),
                 lambda: export_serving_graph(None, 22050, 16000),
                 lambda: save_serving_artifact("a", None, 22050, 16000),
                 lambda: load_serving_artifact("a"),
                 lambda: extract_features_chunked(None, np.zeros(400)),
                 lambda: export_aot.main([
                     "--hubert-checkpoint", "h", "--hifigan-checkpoint",
                     "g", "--kmeans", "k", "--out", "o"]),
                 lambda: trainable_istft_generator(ISTFTGeneratorConfig()),
                 lambda: train_hifigan.main(["--wavs", ".", "--istft",
                                             "--checkpoint-path", "c"]),
                 lambda: make_mesh(),
                 lambda: make_hybrid_mesh(),
                 lambda: InformedInpainter(
                     InpainterConfig(HubertConfig.base(), HiFiGANConfig()),
                     {}, {}, np.zeros((3, 80), np.float32),
                     mesh=cpu_mesh)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and res.stdout == ""


@pytest.mark.parametrize("caller", [(True, True), (False, True),
                                    (True, False)])
def test_full_f32_pins_and_restores_the_tf32_flags(caller):
    from speech_inpainting_torch.device import full_f32
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    try:
        cudnn.allow_tf32, matmul.allow_tf32 = caller
        with full_f32():
            assert (cudnn.allow_tf32, matmul.allow_tf32) == (False, False)
        assert (cudnn.allow_tf32, matmul.allow_tf32) == caller
        with pytest.raises(ZeroDivisionError):
            with full_f32():
                1 / 0
        assert (cudnn.allow_tf32, matmul.allow_tf32) == caller

        @full_f32()
        def inside():
            return cudnn.allow_tf32, matmul.allow_tf32

        assert inside() == (False, False)
        assert (cudnn.allow_tf32, matmul.allow_tf32) == caller
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def test_entry_points_run_in_full_f32(monkeypatch):
    """Each entry point runs its body under `full_f32`: the flags seen
    inside are off though the caller left TF32 on."""
    from speech_inpainting_torch.infer import (aot, ida_inpaint, inpaint,
                                               resynth)
    from speech_inpainting_torch.models.hubert import (
        extract_features_chunked)
    cudnn = torch.backends.cudnn
    seen = []

    def spy(*args, **kwargs):
        seen.append(cudnn.allow_tf32)
        raise RuntimeError("stop")

    monkeypatch.setattr(cudnn, "allow_tf32", True)
    for cls, method, args in (
            (inpaint.InformedInpainter, "batch", ([0.0], [0.0], [0], [0])),
            (inpaint.InformedInpainter, "batch_expected",
             ([0.0], [0], [0], [0])),
            (inpaint.InformedInpainter, "_hifi_masked", ([0.0], [0], [0])),
            (ida_inpaint.IdaInpainter, "inpaint", ([0.0], 0, 1)),
            (resynth.Resynthesizer, "__call__", ([[0]],)),
            (aot.ServingArtifact, "batch", ([0.0], [0.0], [0], [0]))):
        obj = object.__new__(cls)
        obj.device = torch.device("cpu")
        monkeypatch.setattr(torch, "as_tensor", spy)
        with pytest.raises(RuntimeError, match="stop"):
            getattr(cls, method)(obj, *args)
        monkeypatch.undo()
        monkeypatch.setattr(cudnn, "allow_tf32", True)
        assert cudnn.allow_tf32
    # and the functions that are entry points
    monkeypatch.setattr(torch, "as_tensor", spy)
    with pytest.raises(RuntimeError, match="stop"):
        extract_features_chunked(None, [0.0], device="cpu")
    monkeypatch.undo()
    assert seen == [False] * 7
