#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (speech_inpainting_torch) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --unpinned    # the control of `default_flags`

Phases, each printing JSON lines as it goes (flushed, so a cut run shows where
it stopped); any failure raises and exits non-zero:
  device        the card's name and power limit (also printed as nvidia-smi
                gives them, on a line of their own);
  build         compiles the kernel source with nvcc: seconds, the number
                of kernel instantiations, their most registers and how many
                spill (listed by type, tile, conv and K in the `spills` line
                at the end, with the paths whose plans take each);
  kernel_check  K1 (the fused ResBlock1) against its plain PyTorch version
                at the 12 (C, K) shapes of HiFi-GAN V1 with odd T, in float32
                (atol 3e-5) and bfloat16 (rel 3e-2);
  edge_check    K1 and K2 against their plain versions at edge shapes: T
                shorter than one time tile, T not a multiple of 8, B = 3,
                C = 16 with K = 11, d = 5 (same tolerances);
  main          informed inpainting at full width (HuBERT-base + V1, random
                weights from a seed, 100×80 codebook) on B = 4 synthetic 4 s
                utterances with 200 ms masks: kernel launches (two per
                residual step), kernel path vs plain path, card vs CPU on a
                short input, bf16 throughput;
  kernel_time   K1 against its plain version at the main path's shapes
                (same tolerances), then kernel, plain version and library
                chain timed there, per stage and per forward, beside the
                card's bound; the `torch.ops.si.resblock1` operator route
                timed beside the direct call, per forward and in host µs
                per call at a small shape;
  ida_main      decoder-adaptation inpainting (I_da) at full width
                (HuBERT-base tapped at layer 6, 100×768 centroids, the
                CodeGenerator of configs/da_hubert100_lut.json, a 128-wide
                d-vector, random weights from a seed) on synthetic 4 s
                utterances with a 200 ms mask at 1.5 s; the centroids are
                frames of the inputs' own layer-6 features, so units are
                clear: K2 launches per utterance, shapes, units changed by
                the mask, K2 path vs plain path, card vs CPU (layer-6
                features, f0 on voiced frames, units, waveforms), then f32
                and bf16 real-time factors and the parts' times;
  ida_kernel_check  the one-step kernel (K2) against its plain version at
                the 45 (C, K, dilation) shapes of the I_da generator, at the
                path's own B and T (same tolerances);
  ida_kernel_time   K2, its plain version and the library chain timed at
                those shapes, summed per stage and per vocoder call, beside
                the bound; its operator route beside the direct call, as
                for K1;
  default_flags both entry points again under torch's default TF32 flags
                (cuDNN may use TF32 for float32 convolutions): the entry
                points pin full float32 themselves, so the card-vs-CPU gates
                must hold, and so must HuBERT's outputs inside each entry
                point (read by forward hooks) at the features' tolerance;
                the gaps of the modules called outside an entry point under
                those flags are printed beside them;
  ea_large      the I_ea path with HuBERT-large (1024 hidden, 24 layers, 16
                heads) and V1 at full width, B = 4 × 4 s: 72 K1 launches,
                kernel path vs plain path (f32 waveform atol 1e-4, labels
                equal), card vs CPU on a short input (HuBERT's head output
                atol 1e-3, waveform 1e-4, labels equal), bf16 and f32 batch
                times;
  istft_engine  `InformedInpainter(generator=ISTFTGenerator)` at the
                iSTFTNet C8C8I geometry, width 512, with HuBERT-base: 36 K1
                launches, the same checks, and its vocoder and batch times
                beside V1's in turns, bf16 and f32;
  artifacts     `hifi_masked` and `batch_expected`, card vs CPU (atol 1e-4);
  serving       bench.py's flagship (HuBERT-base + V1) in bf16, eight numpy
                batches of B = 64 through a synchronised loop and through
                `PipelinedRunner` at depth 1 and 4 (outputs equal to the
                loop's, audio-s/s), one batch at B = 256 (time, peak
                memory), and K1 vs its plain version at the tiles those
                plans take that no earlier check reached;
  longform      `LongFormInpainter` on a 60 s recording with 5 masks (two
                merged), window 4 s, batch 8, depth 4: untouched outside the
                pasted spans, equal to direct `batch` calls on its windows
                (atol 1e-4), card vs CPU (atol 1e-4);
  cli           `predict_ea.main` on the card on a wav, a HuBERT-large
                `CustomModel` state dict, a V1 `g_*` file and a .npy
                codebook written to a temporary directory: every artifact
                written (mel PNGs where matplotlib is installed), inpainted
                wav within 1 int16 step of a direct call, `--long-form` with
                two masks;
  aot_export    the serving artifact (infer/aot.py) of the main path's
                full-width inpainter, f32 and bf16, and of the iSTFT engine
                override, exported batch-polymorphic on the card for 4 s
                utterances, then loaded and run at B = 4 and 8 in a child
                process that cannot import the port's models, converters or
                live inpainter: K1 launches per batch (72; 36 for the
                engine), waveforms against the live batch (f32 atol 1e-4,
                bf16 rel 3e-2), labels equal; export, load and batch times
                beside the live batch's, ms and audio-s/s;
  aot_plain_generator  the same f32 artifact with the plain `Generator`
                (models/hifigan.py) as the override, whose traced
                ResBlock1s call K2 through `si::resblock_step`, run at B = 4
                in the same child process: 72 K2 launches and no K1 per
                batch, waveform atol 1e-5 of the live call, labels equal;
  export_aot_cli  `export_aot.main --platforms cuda,cpu` on a HuBERT-base
                `CustomModel` state dict, the V1 `g_*` and the codebook as
                files: equal to a direct `save_serving_artifact` (atol
                1e-6), 72 K1 launches, within 1e-4 of the live batch, and
                loaded on the CPU within 1e-4 of the card;
  int8_hubert   `HubertConfig.int8` at HuBERT-base's full width, B = 4 × 4
                s: int8 against f32 by tests/test_int8.py's relative error,
                the card against the CPU on 0.5 s, `dynamic_int8_dot` card
                against CPU, ms per forward beside f32 and bf16;
  ida_cli       `inpaint_da.main` on the card at full width (the config,
                weights and codebook of `ida_main`) on files written to a
                temporary directory: two 4 s wavs in a JSON-lines manifest,
                a reference-layout CodeGenerator `g_*`, an HF HuBERT-base
                directory (config.json + pytorch_model.bin) and a .npy
                codebook; masks 100-400 ms: every artifact written, 180 K2
                launches per utterance per mask, `_inpainted_200.wav` within
                1 int16 step of a direct `IdaInpainter` call, median RTF;
  evaluate_sweep  the mask-sweep harness (`evaluate_sweep`) over the I_ea
                inpainter at full width (HuBERT-base + head, V1 drawn to
                carry the mel, the 100×80 codebook) on a synthetic 4 s
                utterance: masks of 100/200/400 ms × 8 positions (seed
                1234), oracle labels and the mel-centroid UER; 432 K1
                launches (72 per `batch` and per `batch_expected`), kernel
                path vs plain path (waveforms atol 1e-4, labels equal,
                metrics within the CPU tests' tolerances), card vs CPU on
                the short input (one length × 2 positions, the same gates),
                K1 vs its plain version at the B = 8 tiles no earlier check
                reached; card seconds per batch, host metric seconds per
                (wav, mask length), positions per second, the mean table;
  score_cli     `score.main` on the sweep's 400 ms estimates and the clean
                utterance as 22.05 kHz wavs, pair and directory modes with
                `--kmeans` and `--mask`: every value equal to a direct
                `score_pair` call, unit IDs card vs CPU equal, `--text`
                without Whisper prints its note;
  predict_asr_cli  `predict_asr.main --donor` on the full-width I_da files
                of `ida_cli` (every artifact written, `output_tts.wav`
                within 1 int16 step of a direct `UnitResynthTTS` call, 180
                K2 launches, kernel path vs plain path) and `--synth` on
                that rendering (files equal to a direct
                `asr_tts_baseline` call);
  vocode        the `vocode` CLI with a V1 `g_*` (full width, B = 1):
                wav2wav on two 4 s 22.05 kHz wavs, mel2wav on their mels,
                --quantize-mel with a 100×80 codebook, card vs CPU (files
                within 4 int16 steps; the generator's waveform atol 1e-4),
                kernel path vs plain path (atol 1e-4), 72 K2 launches per
                forward, K2 against its plain version at every (C, K, d)
                step of these lengths, ms per forward (f32, bf16);
  v3            `vocode wav2wav` with a V3 `g_*` (ResBlock2, full width):
                card vs CPU, no K2 launch, ms per forward beside V1's;
  f0vq          `FoVQVAE.__call__` at configs/f0_vqvae.json's width on the
                f0 of a 4 s utterance from a reference `g_*`: card vs CPU,
                reconstruction atol 1e-4, units equal;
  content_vq    `vocode codes` and the CodeGenerator's content-VQ forward
                (from units and from a waveform) at tests/test_codegen.py's
                geometry (generator 64 wide): card vs CPU, units equal,
                waveforms atol 1e-4;
  kmeans_fit    `fit_kmeans` with k = 100 over 200 000 × 768 rows, 50
                iterations, 3 restarts (seconds, inertia); `_lloyd` card vs
                CPU from one start on 20 000 rows (inertia rel 1e-5, at
                most 0.1% of labels different);
  ea_train_parity  one I_ea train step at HuBERT-base's full width, B = 2
                × 2 s, f32: card vs CPU (loss rel 1e-5, accuracies equal,
                parameters rtol 2e-5 atol 2e-6), each gradient against
                the step in float64 (1e-4 of the tensor's largest, or 4 ×
                the CPU's float32 gap), the zero-gradient k_proj biases to
                their noise bound; then on the card grad_accum 2 vs 1, a
                nan batch under the guard (bit-equal, one skip) and the
                frozen encoder (bit-equal, head moved);
  ea_train      HuBERT-large + head, B = 16 × 5 s, cos_sim, 100 × 80
                codebook: 12 bf16 steps with the guard off, 12 with it on,
                4 f32 steps (ms per step by CUDA events, audio-s/s, peak
                memory, the step's bound), one bf16 step profiled; losses
                finite and falling;
  train_ea_cli  `train_ea.main` on 32 × 5 s wavs, an HF HuBERT-large
                directory and a 100 × 80 codebook, twice (2 steps, then a
                resume from step 2 to 4), then `predict_ea.main` from its
                `last_` (216 K1 launches); the head from `last_` equal to
                the trained module (atol 1e-6, f32);
  gan_step_parity  one GAN step (vanilla recipe) at V1's full width with
                the full MPD and MSD, B = 2 × 8192, f32, batched_disc on:
                card vs CPU (losses rel 1e-5; parameters, gradients,
                moments and u/v rtol 2e-5 atol 2e-6, or near a float64
                step, per tensor within testing.NOISE's share and excess),
                then on the card the second update at the decayed rate, a
                nan batch under the guard (bit-equal, one skip, u/v
                advanced) and batched_disc off against on;
  gan_train     the modified recipe of configs/hifigan_ft_modified.json
                (V1, full MPD and MSD), B = 16 × 44 288, mask_len 20, a
                100 × 80 codebook: 8 f32 steps and 8 with disc_bf16 (ms per
                step by CUDA events, audio-s/s, peak memory, the bound),
                one f32 step profiled; losses finite, mel_error falling;
  train_hifigan_cli  `train_hifigan.main --modified` on 32 × 3 s wavs with
                a 16-wav validation filelist (2 steps and a sweep of 72 K2
                launches), again resuming 2 → 4, then `predict_ea` (216 K1
                launches) and `vocode wav2wav` (72 K2 per forward) from the
                g_ it wrote; that g_ served equal to the module's fold();
  istft_gan_step_parity  the GAN step with the trainable iSTFT-head
                generator (`WNISTFTGenerator`, C8C8I at width 512), the
                vanilla recipe, the full MPD and MSD, B = 2 × 8192, f32:
                card vs CPU beside a float64 CPU step (losses rel 1e-5,
                every tensor by testing.parity_gate), the elements behind
                a discriminator leaky-ReLU input that the two float32 runs
                put on opposite sides of its kink, within rounding of it
                in float64, held apart (each flip and its margin printed);
  istft_gan_train  eight steps of it at B = 16 × 8192 (host seconds per
                step through utils/timing.force, median and range of steps
                2-8, CUDA-event ms, audio-s/s, peak memory, the bound, one
                step under utils/profiling.trace); `train_hifigan.main
                --istft` twice (2 steps and a validation sweep of 36 K1
                launches, resumed 2 → 4), K1 vs its plain version at the
                sweep's new tiles; the generator it trained, from its g_,
                folded as the vocoder of the main path's inpainter (B = 4 ×
                4 s: 36 K1 launches, kernel vs plain path, card vs CPU);
  f0vq_step_parity  three steps of the pitch quantizer's trainer
                (train/f0vq.py) at configs/f0_vqvae.json's width, B = 16 ×
                208 f0 frames, from an uninitialised codebook: card vs CPU
                (labels equal at every step, losses rel 1e-5, parameters,
                moments and codebook buffers by testing.parity_gate beside
                a float64 step), the first step initialising the codebook
                and restarting codes;
  f0vq_train    300 steps of it on the f0 of 64 synthetic 3 s utterances
                (ms per step by CUDA events, f0 frames/s, peak memory, the
                bound, one step profiled, the EMA update alone): recon
                falling, used_curr above 1;
  prep_and_train_f0vq_cli  the I_da preparation as a user runs it:
                `prep preprocess → manifest → features → kmeans_cli fit →
                quantize → parse-codes → f0-stats` (HuBERT-base from an HF
                directory), `train_f0vq` twice (2 steps, resumed 2 → 4), a
                CodeDataset batch, then one I_da utterance with the trained
                pitch quantizer (180 K2 launches, kernel vs plain path);
                units card vs CPU equal outside HuBERT's tolerance margin;
  da_step_parity  the unit HiFi-GAN trainer's step (train/da.py), card vs
                CPU beside a float64 CPU step, by testing.parity_gate:
                decoder-only at configs/da_hubert100_lut.json's full width
                (B = 2 × 8960, the full MPD and MSD, the pitch quantizer
                frozen: bit-unchanged, out of the optimizer), and the joint
                regime at `content_vq`'s geometry (3 steps from an
                uninitialised codebook with the same candidates, labels
                equal, a restart on the first step; a NaN batch bit-equal,
                one skip; the candidates' generator through g_/do_);
  da_train      the decoder-only DA trainer at full width, B = 16 × 8960
                (8.96 s of audio a step), 8 f32 steps and 8 with disc_bf16
                (ms per step by CUDA events, audio-s/s, peak memory, the
                bound), one f32 step profiled; losses finite, mel_error
                falling, the pitch quantizer unchanged;
  train_da_cli  `train_da.main` twice (1 step, resumed 1 → 2) on what
                `prep_and_train_f0vq_cli` left (its units manifest, f0
                statistics and train_f0vq directory), a validation sweep
                of 90 K2 launches each, then one I_da utterance through the
                CodeGenerator it trained (180 K2 launches, kernel vs plain
                path), and K2 against its plain version at the sweep's
                shapes;
  dist_world1   the trainers' `--mesh` at world size 1 over NCCL on the
                card (a process group of one on a free localhost port):
                `train_hifigan --modified` (configs/hifigan_ft_modified.json,
                full width, B = 16 × 44 288, f32, 2 steps and a sweep of 72
                K2 launches) held against the same run without --mesh by
                testing.parity_gate, and `train_ea` with HuBERT-large (B =
                16 × 5 s, bf16, 2 steps, on train_ea_cli's corpus) whose
                first step's reduced gradients are within 1e-2 of the
                largest of its run without, and their norm before the
                clip within 1e-2 of its; ms per step of each (CUDA events
                around the CLI's step); no group left after;
  dist_world2_one_card  two worker processes (`--dist-worker`) on the one
                card in a gloo group: the I_ea step (HuBERT-base, 8 rows a
                rank of B = 16 × 5 s, f32, 2 steps: losses summed over the
                ranks) and the V1 GAN step (8 rows a rank of 16 × 8192, the
                full MPD/MSD, parity_gate; each rank's validation sweep of
                72 K2) against the world-1 step on all rows, and
                `InformedInpainter(mesh=)` at full width on B = 8 × 4 s (72
                K1 a rank; waveforms within 1e-4 of world 1, labels
                equal);
  tp_world2_one_card  in the same workers, HuBERT-base split by
                parallel/tp.py over ("dp", 1) × ("tp", 2), its head output
                within 1e-3 of the unsharded module's.
Then the `spills` and `kernels` lines (K1's and K2's launches on each
path), and last {"ok": true, "device": {...}}.

`--unpinned` runs only `device`, `build` and `default_flags`, with the
entry points' pinning made a no-op: the phase must then fail (exit 0 when
it does, 1 when it passes), which shows that its gates see a missing pin.

No phase sets the TF32 flags for the whole run: the entry points pin full
float32 themselves (`speech_inpainting_torch.device.full_f32`), and the
plain versions, the library timings and the module calls made outside an
entry point run inside `full_f32()` here.

Exits 1 without printing a result when no CUDA device is present.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 0
F32_ATOL = 3e-5    # tests/test_pallas.py's ResBlock1 tolerance
BF16_RTOL = 3e-2   # bench.py's bf16 kernel-canary tolerance
MAIN_ATOL = 1e-4   # kernel path vs plain path, f32 waveform in [-1, 1]
CPU_ATOL = 1e-4    # card vs CPU on a short input, f32 waveform
HUBERT_ATOL = 1e-3  # card vs CPU, HuBERT's layer-6 features (LayerNorm
#                    scale, after 7 convs and 6 layers of f32 sums of
#                    768-3072 terms)
F0_RTOL = 2e-3     # card vs CPU, f0 in Hz on voiced frames (the I_da
#                    parity test's f0 tolerance)
IDA_CONFIG = (Path(__file__).resolve().parent / "configs"
              / "da_hubert100_lut.json")
IDA_TAP = 6        # cli/inpaint_da.py's default HuBERT layer
IDA_SECONDS = 4.0
IDA_MASK = 3200    # 200 ms at 16 kHz, at the default start of 1.5 s
IDA_UTTERANCES = 3
# H100 SXM, dense: bf16 on the tensor cores, f32 outside them (the FMA
# figure), and TF32 on the tensor cores, which the f32 kernel route uses
# three times per f32 product (3×TF32)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# ------------------------------------------------------------------- timing

def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def resblock_bound_ms(B, C, T, K, S, dtype_name,
                      route=True) -> tuple[float, float]:
    """The two floors of one ResBlock1, in ms: its FLOP over the peak rate of
    the kernel's route for the type, and its bytes (each input read once,
    the output written once) over the memory rate. The least time is the
    larger. bf16 runs on the tensor cores; f32 on them as 3×TF32 (three
    products per f32 one) or, with route=False, the FMA figure outside
    them."""
    size = 4 if dtype_name == "float32" else 2
    flops = 4.0 * S * C * C * K * T * B
    nbytes = size * (2 * B * C * T + 2 * S * C * C * K + 2 * S * C)
    if dtype_name == "float32" and route:
        t_ops = 3 * flops / PEAK_TF32
    else:
        t_ops = flops / PEAK_FLOPS[dtype_name]
    return 1e3 * t_ops, 1e3 * nbytes / PEAK_BYTES


def pinned(fn, *args):
    """fn(*args) in full float32 (TF32 off): the plain versions' calls."""
    from speech_inpainting_torch.device import full_f32
    with full_f32():
        return fn(*args)


def library_ms(torch, fn, iters):
    """The library yardstick: the same F.conv1d chain with cuDNN's
    autotuner choosing each convolution's algorithm, TF32 off."""
    from speech_inpainting_torch.device import full_f32
    torch.backends.cudnn.benchmark = True
    try:
        with full_f32():
            return cuda_ms(fn, iters, warmup=2)
    finally:
        torch.backends.cudnn.benchmark = False


def host_us(torch, fn, calls: int = 50) -> float:
    """Host microseconds per call of `fn`: Python, dispatch and the
    launches' enqueue, over `calls` back-to-back calls after a synchronised
    warm-up (few enough that the launch queue never fills, so nothing waits
    on the card)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


ROUTE_SHAPE = (1, 32, 512, 3)   # B, C, T, K: a call the card finishes
#                                 faster than the host issues it


def _route_us(torch, dtype, step: bool) -> dict:
    """K1's (or, with `step`, K2's) direct ctypes call against its
    `torch.library` operator: host µs per call at ROUTE_SHAPE, where the
    host's cost is all there is, in turns (direct, op, op, direct) twice."""
    from speech_inpainting_torch.ops import resblock as rb
    B, C, T, K = ROUTE_SHAPE
    rng = np.random.default_rng(SEED)
    if step:
        args = _step_inputs(rng, C, T, K, torch, dtype, B)
        direct = lambda: rb.fused_resblock_step(*args, 3)
        op = lambda: torch.ops.si.resblock_step(*args, 3)
    else:
        args = _resblock_inputs(rng, B, C, T, K, 3, torch, dtype)
        direct = lambda: rb.fused_resblock1(*args, (1, 3, 5))
        op = lambda: torch.ops.si.resblock1(*args, [1, 3, 5])
    t = [host_us(torch, f, 100) for f in (direct, op, op, direct) * 2]
    return {"shape_B_C_T_K": ROUTE_SHAPE,
            "direct_us_per_call": sum(t[0::4] + t[3::4]) / 4,
            "op_us_per_call": sum(t[1::4] + t[2::4]) / 4}


# ------------------------------------------------------------------- phases

def phase_device(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    info = {"phase": "device", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


# resblock_conv<T, WM, WN, MT, NT, KSPLIT, kConv2, K> as nvcc mangles it
_KERNEL_NAME = re.compile(
    r"resblock_convI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E"
    r"Li(\d+)ELb([01])ELi(\d+)E")


def _ptxas_table(log: str) -> list[dict]:
    """ptxas's registers and spill bytes for each instantiation of the
    kernel template in nvcc's -Xptxas -v output, by (type, tile, conv, K);
    the tile is (16·MT·WM output channels, 8·NT·WN positions)."""
    rows, cur = {}, None
    for ln in log.splitlines():
        m = _KERNEL_NAME.search(ln)
        if m and ("Compiling entry function" in ln
                  or "Function properties for" in ln):
            t, wm, wn, mt, nt, _, conv2, k = m.groups()
            key = ("float32" if t == "f" else "bfloat16",
                   16 * int(mt) * int(wm), 8 * int(nt) * int(wn),
                   2 if conv2 == "1" else 1, int(k))
            cur = rows.setdefault(key, dict(zip(
                ("dtype", "co_tile", "t_tile", "conv", "K"), key)))
        elif cur is not None and "spill stores" in ln:
            nums = [int(v) for v in re.findall(r"(\d+) bytes", ln)]
            cur["spill_stores"], cur["spill_loads"] = nums[1], nums[2]
        elif cur is not None and "Used" in ln and "registers" in ln:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             ln).group(1))
    return list(rows.values())


def phase_build() -> list[dict]:
    """Builds the kernels; returns ptxas's counts of the instantiations
    that spill (`_ptxas_table`), which `main` marks with the paths whose
    plans take them."""
    from speech_inpainting_torch.kernels import build
    t0 = time.perf_counter()
    done = build.build("resblock1")
    table = _ptxas_table(done["log"]) if done else []
    spills = [r for r in table
              if r.get("spill_stores") or r.get("spill_loads")]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": done is not None, "instantiations": len(table),
          "max_registers": max((r.get("registers", 0) for r in table),
                               default=None),
          "spilling": len(spills)})
    return spills


def _plan_tiles(B, stage_T, kernel_sizes, dilations) -> set:
    """(co tile, time tile, K) of every launch a path's plans take."""
    from speech_inpainting_torch.ops.resblock import _plan
    return {(p.co_tile, p.t_tile, K)
            for C, T in stage_T.items()
            for K, dils in zip(kernel_sizes, dilations) for d in dils
            for p in [_plan(B, C, T, K, d)]}


def _resblock_inputs(rng, B, C, T, K, S, torch, dtype):
    # weights at a per-conv gain that keeps activations O(1) at every width
    # (0.5/√(C·K); test_pallas.py's 0.05 at C=32, K=3)
    scale = 0.5 / math.sqrt(C * K)
    arrs = (rng.standard_normal((B, C, T)),
            rng.standard_normal((S, C, C, K)) * scale,
            rng.standard_normal((S, C)) * 0.1,
            rng.standard_normal((S, C, C, K)) * scale,
            rng.standard_normal((S, C)) * 0.1)
    return [torch.tensor(a, dtype=dtype, device="cuda") for a in arrs]


def phase_kernel_check(torch) -> dict:
    """Kernel vs plain version at V1's 12 (C, K) shapes, B = 2, odd T."""
    from speech_inpainting_torch.ops.resblock import (fused_resblock1,
                                                      resblock1_reference)
    rng = np.random.default_rng(SEED)
    dils, S = (1, 3, 5), 3
    worst = {"f32_max_abs_err": 0.0, "bf16_rel_err": 0.0}
    for C in (256, 128, 64, 32):
        for K in (3, 7, 11):
            f32 = _resblock_inputs(rng, 2, C, 2049, K, S, torch, torch.float32)
            got = fused_resblock1(*f32, dils)
            want = pinned(resblock1_reference, *f32, dils)
            err = (got - want).abs().max().item()
            bf = [t.to(torch.bfloat16) for t in f32]
            got_b = fused_resblock1(*bf, dils).float()
            want_b = pinned(resblock1_reference, *bf, dils).float()
            rel = ((got_b - want_b).abs().max() / want_b.abs().max()).item()
            torch.cuda.synchronize()
            ok = err <= F32_ATOL and rel <= BF16_RTOL
            emit({"phase": "kernel_check", "C": C, "K": K, "B": 2, "T": 2049,
                  "f32_max_abs_err": err, "f32_atol": F32_ATOL,
                  "bf16_rel_err": rel, "bf16_rtol": BF16_RTOL, "ok": ok})
            if not ok:
                raise AssertionError(f"fused_resblock1 disagrees at C={C} "
                                     f"K={K}: f32 {err}, bf16 rel {rel}")
            worst["f32_max_abs_err"] = max(worst["f32_max_abs_err"], err)
            worst["bf16_rel_err"] = max(worst["bf16_rel_err"], rel)
    return worst


# T shorter than one time tile, T not a multiple of 8, B = 3, and C = 16
# with K = 11, d = 5: (B, C, T, K) for K1 (dilations 1, 3, 5), each of whose
# steps is also a K2 shape
EDGE_SHAPES = [(1, 256, 5, 3), (1, 256, 37, 11), (1, 16, 5, 11),
               (1, 16, 37, 11), (3, 128, 1001, 7), (3, 32, 1001, 11),
               (3, 16, 1001, 11)]


def phase_edge_check(torch) -> dict:
    """K1 and K2 against their plain versions at EDGE_SHAPES, f32 atol and
    bf16 rel as in `phase_kernel_check`."""
    from speech_inpainting_torch.ops.resblock import (
        fused_resblock1, fused_resblock_step, resblock1_reference,
        resblock_step_reference)
    rng = np.random.default_rng(SEED + 2)
    dils, S = (1, 3, 5), 3
    worst = {name: {"f32_max_abs_err": 0.0, "bf16_rel_err": 0.0, "shapes": 0}
             for name in ("K1", "K2")}
    for B, C, T, K in EDGE_SHAPES:
        f32 = _resblock_inputs(rng, B, C, T, K, S, torch, torch.float32)
        cases = [("K1", fused_resblock1, resblock1_reference, f32, dils)]
        cases += [("K2", fused_resblock_step, resblock_step_reference,
                   [f32[0]] + [t[s] for t in f32[1:]], d)
                  for s, d in enumerate(dils)]
        for name, kernel, ref, args, dil in cases:
            err = (kernel(*args, dil) - pinned(ref, *args, dil)).abs().max()
            bf = [t.to(torch.bfloat16) for t in args]
            got, want = kernel(*bf, dil).float(), pinned(ref, *bf, dil).float()
            rel = ((got - want).abs().max() / want.abs().max()).item()
            err = err.item()
            ok = err <= F32_ATOL and rel <= BF16_RTOL
            emit({"phase": "edge_check", "kernel": name, "B": B, "C": C,
                  "T": T, "K": K, "dilation": dil, "f32_max_abs_err": err,
                  "bf16_rel_err": rel, "ok": ok})
            if not ok:
                raise AssertionError(f"{name} disagrees at edge shape B={B} "
                                     f"C={C} T={T} K={K} d={dil}: f32 {err}, "
                                     f"bf16 rel {rel}")
            w = worst[name]
            w["f32_max_abs_err"] = max(w["f32_max_abs_err"], err)
            w["bf16_rel_err"] = max(w["bf16_rel_err"], rel)
            w["shapes"] += 1
    emit({"phase": "edge_check_summary", **worst})
    return worst


def _stage_sums(stages: dict, C: int, row: dict) -> None:
    acc = stages.setdefault(C, {"ms": 0.0, "plain_ms": 0.0,
                                "library_ms": 0.0, "bound_ms": 0.0})
    for key in acc:
        acc[key] += row[key]


def phase_kernel_time(torch, stage_T: dict) -> dict:
    """Kernel against its plain version, then kernel, plain version and
    library chain timed, at the main path's shapes: the 12 ResBlock1 calls
    of one V1 forward at B = 4 (T per stage from `stage_T`), per dtype,
    summed over the 12. Raises where the kernel disagrees (f32 atol, bf16
    rel, as in `phase_kernel_check`)."""
    from speech_inpainting_torch.ops.resblock import (fused_resblock1,
                                                      resblock1_reference)
    rng = np.random.default_rng(SEED)
    dils, S = (1, 3, 5), 3
    op = torch.ops.si.resblock1
    timed = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        tot = {"ms": 0.0, "op_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "bound_ms": 0.0, "bound_fma_ms": 0.0, "err": 0.0}
        floors = {"operations": 0.0, "bytes": 0.0}
        stages = {}
        for C, T in stage_T.items():
            for K in (3, 7, 11):
                args = _resblock_inputs(rng, 4, C, T, K, S, torch, dtype)
                got = fused_resblock1(*args, dils).float()
                want = pinned(resblock1_reference, *args, dils).float()
                err, tol = (got - want).abs().max().item(), F32_ATOL
                if dtype == torch.bfloat16:
                    err, tol = err / want.abs().max().item(), BF16_RTOL
                del got, want
                if not err <= tol:
                    raise AssertionError(
                        f"fused_resblock1 disagrees at the main path's shape "
                        f"B=4 C={C} T={T} K={K} {name}: {err} > {tol}")
                tot["err"] = max(tot["err"], err)
                ms = cuda_ms(lambda: fused_resblock1(*args, dils), 3)
                tot["op_ms"] += cuda_ms(lambda: op(*args, list(dils)), 3)
                plain_ms = cuda_ms(
                    lambda: pinned(resblock1_reference, *args, dils), 3)
                lib = library_ms(
                    torch, lambda: resblock1_reference(*args, dils), 3)
                t_ops, t_bytes = resblock_bound_ms(4, C, T, K, S, name)
                bound = max(t_ops, t_bytes)
                row = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib,
                       "bound_ms": bound}
                emit({"phase": "kernel_time", "dtype": name, "B": 4, "C": C,
                      "T": T, "K": K, "err": err, "tolerance": tol, **row,
                      "bound_by": "operations" if t_ops >= t_bytes
                      else "bytes"})
                _stage_sums(stages, C, row)
                for key, v in row.items():
                    tot[key] += v
                tot["bound_fma_ms"] += max(resblock_bound_ms(
                    4, C, T, K, S, name, route=False))
                floors["operations"] += t_ops
                floors["bytes"] += t_bytes
                del args
        tot["route"] = _route_us(torch, dtype, step=False)
        # the sum of the 12 calls' floors is bound by what dominates it
        tot["bound_by"] = max(floors, key=floors.get)
        tot["by_C"] = stages
        timed[name] = tot
        emit({"phase": "kernel_time_per_forward", "dtype": name, **tot})
    return timed


def _ea_setup(rng) -> tuple:
    """The full-width I_ea configuration (HuBERT-base + head, V1), its
    trees and a 100×80 codebook, drawn from `rng`."""
    from speech_inpainting_torch.infer.inpaint import InpainterConfig
    from speech_inpainting_torch.models.hifigan import HiFiGANConfig
    from speech_inpainting_torch.models.hubert import HubertConfig
    from speech_inpainting_torch.testing import generator_tree, hubert_tree
    hcfg, gcfg = HubertConfig.base(), HiFiGANConfig()
    hp, gp = hubert_tree(hcfg, 80, rng), generator_tree(gcfg, rng)
    centroids = rng.standard_normal((100, 80)).astype(np.float32)
    return InpainterConfig(hcfg, gcfg), hp, gp, centroids


def phase_main(torch) -> dict:
    from speech_inpainting_torch.infer.inpaint import (InformedInpainter,
                                                       InpainterConfig,
                                                       _masked_mel22)
    from speech_inpainting_torch.models.hifigan import HiFiGANConfig
    from speech_inpainting_torch.models.hubert import HubertConfig
    from speech_inpainting_torch.ops.resblock import fused_resblock1
    from speech_inpainting_torch.device import full_f32
    from speech_inpainting_torch.testing import synthetic_batch
    rng = np.random.default_rng(SEED)
    setup = _ea_setup(rng)
    cfg, hp, gp, centroids = setup
    hcfg, gcfg = cfg.hubert, cfg.hifigan
    B, seconds = 4, 4.0
    w22, w16, pos, lens = synthetic_batch(rng, B, seconds)
    inp = InformedInpainter(cfg, hp, gp, centroids)
    # two kernel launches per residual step: 4 stages × 3 blocks × 3 steps
    n_launches = 2 * len(gcfg.upsample_rates) * sum(
        len(d) for d in gcfg.resblock_dilation_sizes)

    fused_resblock1.launches = 0
    out = inp.batch(w22, w16, pos, lens)
    torch.cuda.synchronize()
    launches = fused_resblock1.launches
    # 200 hop-441 mel frames, regridded to floor(200·441/256) = 344 frames
    # of hop 256
    T_out = (1 + (w22.shape[1] + 2 * 312 - 1024) // 441) * 441 // 256 * 256
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    want = {"inpainted": (B, T_out), "mel_masked": (B, 80, 200),
            "mel_inpainted": (B, 80, 200), "pred_labels": (B, 199)}
    finite = all(bool(torch.isfinite(v.float()).all()) for v in out.values())

    inp.generator.use_kernel = False
    plain = inp.batch(w22, w16, pos, lens)
    inp.generator.use_kernel = True
    diff = (out["inpainted"] - plain["inpainted"]).abs().max().item()
    agree = (out["pred_labels"] == plain["pred_labels"]).float().mean().item()

    # the same modules on the CPU, on a short input (the CPU runs the plain
    # ResBlock1 and torch's CPU convolutions)
    cpu = InformedInpainter(cfg, hp, gp, centroids, device="cpu")
    s22, s16, spos, slens = synthetic_batch(np.random.default_rng(SEED + 1),
                                            1, 0.5, mask_frames=5)
    on_card = inp.batch(s22, s16, spos, slens)["inpainted"].cpu()
    on_cpu = cpu.batch(s22, s16, spos, slens)["inpainted"]
    cpu_diff = (on_card - on_cpu).abs().max().item()

    ok = (launches == n_launches and shapes == want and finite
          and diff <= MAIN_ATOL and agree == 1.0 and cpu_diff <= CPU_ATOL)
    emit({"phase": "main_f32", "B": B, "seconds": seconds,
          "launches": launches, "expected_launches": n_launches,
          "shapes": shapes, "finite": finite,
          "kernel_vs_plain_max_abs": diff, "tolerance": MAIN_ATOL,
          "pred_labels_agreement": agree, "card_vs_cpu_max_abs": cpu_diff,
          "cpu_tolerance": CPU_ATOL, "ok": ok})
    if not ok:
        raise AssertionError("main path check failed")

    # throughput on inputs already on the card, f32 and then bf16 (the same
    # weights and inputs), and where one bf16 batch spends its time
    dev = [torch.as_tensor(a, device="cuda") for a in (w22, w16, pos, lens)]
    audio_s = B * T_out / 22050.0
    f32_batch = cuda_ms(lambda: inp.batch(*dev), 3) / 1e3
    hb, gb = HubertConfig.base(dtype=torch.bfloat16), HiFiGANConfig(
        dtype=torch.bfloat16)
    inp16 = InformedInpainter(InpainterConfig(hb, gb), hp, gp, centroids)
    out16 = inp16.batch(*dev)
    if not all(bool(torch.isfinite(v.float()).all()) for v in out16.values()):
        raise AssertionError("bf16 main path gave non-finite output")
    iters = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        inp16.batch(*dev)
    torch.cuda.synchronize()
    per_batch = (time.perf_counter() - t0) / iters
    with torch.inference_mode(), full_f32():
        mel = torch.zeros(B, 80, T_out // 256, device="cuda")
        gen_ms = cuda_ms(lambda: inp16.generator(mel), 3)
        hub_ms = cuda_ms(lambda: inp16.hubert(dev[1]), 3)
        front_ms = cuda_ms(lambda: _masked_mel22(dev[0], dev[2], dev[3]), 3)
    emit({"phase": "main_throughput", "B": B, "audio_seconds": audio_s,
          "f32_batch_seconds": f32_batch,
          "f32_audio_seconds_per_second": audio_s / f32_batch,
          "bf16_batch_seconds": per_batch,
          "bf16_audio_seconds_per_second": audio_s / per_batch,
          "bf16_generator_ms": gen_ms, "bf16_hubert_ms": hub_ms,
          "frontend_ms": front_ms})
    return {"launches": launches,
            "T": {C: T_out // 256 * math.prod(gcfg.upsample_rates[:i + 1])
                  for i, C in enumerate((256, 128, 64, 32))},
            "kernel_sizes": gcfg.resblock_kernel_sizes,
            "dilations": gcfg.resblock_dilation_sizes,
            "setup": setup}


def _ida_setup(torch) -> dict:
    """The full-width I_da configuration, trees, d-vector and utterances
    from SEED. The 100×768 centroids are frames of HuBERT's layer-6 features
    on the CPU, of the checked inputs clean and masked (as the I_da parity
    test draws its own), so that each frame has a clear nearest unit."""
    from speech_inpainting_torch.convert.from_jax import hubert_model_from_jax
    from speech_inpainting_torch.models.codegen import CodeGeneratorConfig
    from speech_inpainting_torch.models.hubert import HubertConfig
    from speech_inpainting_torch.ops.masking import mask_span
    from speech_inpainting_torch.testing import (codegen_tree,
                                                 hubert_model_tree,
                                                 synthetic_utterance)
    with open(IDA_CONFIG) as fh:
        cfg = CodeGeneratorConfig.from_dict(json.load(fh))
    rng = np.random.default_rng(SEED)
    params, vq = codegen_tree(cfg, rng)
    hp = hubert_model_tree(HubertConfig.base(), rng)
    emb = rng.standard_normal(cfg.embedding_dim).astype(np.float32)
    utts = [synthetic_utterance(rng, IDA_SECONDS)
            for _ in range(IDA_UTTERANCES)]
    short = utts[1][:8000]          # the card-vs-CPU input, mask 1600 at 3200
    hub = hubert_model_from_jax(HubertConfig.base(), hp, device="cpu")
    pool = []
    with torch.inference_mode():
        for u, start, size in ((utts[0], 24000, IDA_MASK), (short, 3200,
                                                            1600)):
            x = torch.as_tensor(u)
            for y in (x, mask_span(x + 1e-6, start, size)):
                pool.append(hub(y[None], tap_layer=IDA_TAP)[0])
    pool = torch.cat(pool).numpy()
    centroids = pool[rng.choice(len(pool), 100, replace=False)]
    return dict(cfg=cfg, params=params, vq=vq, hp=hp, emb=emb, utts=utts,
                short=short, centroids=centroids)


def _ida_inpainter(torch, setup: dict, dtype, device=None):
    from speech_inpainting_torch.infer.ida_inpaint import IdaInpainter
    from speech_inpainting_torch.models.hubert import HubertConfig
    cfg = setup["cfg"]
    cfg = dataclasses.replace(cfg, hifigan=dataclasses.replace(
        cfg.hifigan, dtype=dtype))
    return IdaInpainter(cfg, setup["params"], setup["vq"],
                        HubertConfig.base(dtype=dtype), setup["hp"],
                        setup["centroids"], tap_layer=IDA_TAP, device=device)


def _unit_margin(torch, feats, centroids) -> float:
    """The least gap, over frames, between the nearest and the second
    nearest centroid's squared distance, relative to the nearest's."""
    from speech_inpainting_torch.quantize.kmeans import pairwise_sqdist
    d = pairwise_sqdist(feats, torch.as_tensor(centroids)).sort(-1).values
    return ((d[:, 1] - d[:, 0]) / d[:, 0].clamp(min=1e-6)).min().item()


def _module_gaps(torch, inp, cpu, utt) -> dict:
    """HuBERT's tapped features and the f0 track of one utterance, called
    as modules outside an entry point, card against CPU, under the TF32
    flags the caller has set."""
    from speech_inpainting_torch.ops.f0 import extract_f0
    with torch.inference_mode():
        feat_card = inp.hubert(torch.as_tensor(utt, device="cuda")[None],
                               tap_layer=IDA_TAP)[0].cpu()
        feat_cpu = cpu.hubert(torch.as_tensor(utt)[None],
                              tap_layer=IDA_TAP)[0]
    f0_card = extract_f0(torch.as_tensor(utt, device="cuda")).cpu()
    f0_cpu = extract_f0(torch.as_tensor(utt))
    voiced = f0_cpu > 0
    f0_rel = ((f0_card - f0_cpu).abs() / f0_cpu.clamp(min=1.0))[voiced]
    return {"features_max_abs": (feat_card - feat_cpu).abs().max().item(),
            "f0_voicing_equal": bool(torch.equal(f0_card > 0, voiced)),
            "f0_frames_voiced": int(voiced.sum()),
            "f0_frames": int(f0_cpu.numel()),
            "f0_voiced_max_rel": f0_rel.max().item() if f0_rel.numel()
            else 0.0}


def _ida_card_vs_cpu(torch, inp, cpu, setup) -> tuple[bool, float]:
    """The I_da entry point on the short input with its own mask, card
    against CPU: unit streams equal, and the waveforms' largest gap."""
    short, emb = setup["short"], setup["emb"]
    on_card = inp(short, 1600, mask_start=3200, emb=emb)
    on_cpu = cpu(short, 1600, mask_start=3200, emb=emb)
    codes_equal = all(bool(torch.equal(on_card[k].cpu(), on_cpu[k]))
                      for k in ("code_clean", "code_inpainted"))
    diff = max((on_card[k].cpu() - on_cpu[k]).abs().max().item()
               for k in ("audio_gen", "audio_inpainted"))
    return codes_equal, diff


def phase_ida_main(torch) -> dict:
    from speech_inpainting_torch.device import full_f32
    from speech_inpainting_torch.ops.f0 import extract_f0
    from speech_inpainting_torch.ops.resblock import (fused_resblock1,
                                                      fused_resblock_step)
    setup = _ida_setup(torch)
    utts, emb = setup["utts"], setup["emb"]
    inp = _ida_inpainter(torch, setup, torch.float32)
    gcfg = inp.cfg.hifigan
    # two K2 launches per residual step: 5 stages × 3 blocks × 3 steps, for
    # each of the two vocoder calls (clean units, inpainted units)
    n_launches = 2 * 2 * len(gcfg.upsample_rates) * sum(
        len(d) for d in gcfg.resblock_dilation_sizes)

    fused_resblock_step.launches = fused_resblock1.launches = 0
    out = inp(utts[0], IDA_MASK, emb=emb)
    torch.cuda.synchronize()
    launches, k1_launches = (fused_resblock_step.launches,
                             fused_resblock1.launches)
    # HuBERT's frame count, and the samples left after the alignment of
    # (audio, 320-sample units, 80-sample f0 frames) and the 1280 trim
    n_code = len(utts[0])
    for k, s in zip(inp.hubert_cfg.conv_kernel, inp.hubert_cfg.conv_stride):
        n_code = (n_code - k) // s + 1
    n = min(len(utts[0]) // 320, n_code,
            inp.f0_cfg.num_frames(len(utts[0])) // 4) * 320
    n -= n % 1280
    frames = n // inp.code_hop
    shapes = {k: tuple(v.shape) for k, v in out.items() if k != "rtf"}
    want = {"audio_gt": (n,), "audio_mask": (n,), "audio_gen": (n,),
            "audio_inpainted": (n,), "code_clean": (n_code,),
            "code_inpainted": (frames,)}
    finite = all(bool(torch.isfinite(v.float()).all())
                 for k, v in out.items() if k != "rtf")
    n_inside = int((out["code_inpainted"]
                    != out["code_clean"][:frames]).sum())

    inp.codegen.generator.use_kernel = False
    plain = inp(utts[0], IDA_MASK, emb=emb)
    inp.codegen.generator.use_kernel = True
    codes_equal = all(bool(torch.equal(out[k], plain[k]))
                      for k in ("code_clean", "code_inpainted"))
    diff = max((out[k] - plain[k]).abs().max().item()
               for k in ("audio_gen", "audio_inpainted"))

    # the same modules on the CPU: the tapped features and the f0 track of
    # a whole utterance, then the path on a short input with its own mask
    cpu = _ida_inpainter(torch, setup, torch.float32, device="cpu")
    with full_f32():
        gaps = _module_gaps(torch, inp, cpu, utts[0])
    feat_diff, f0_rel = gaps["features_max_abs"], gaps["f0_voiced_max_rel"]
    voicing_equal = gaps["f0_voicing_equal"]
    with torch.inference_mode():
        feat_cpu = cpu.hubert(torch.as_tensor(utts[0])[None],
                              tap_layer=IDA_TAP)[0]
    margin = _unit_margin(torch, feat_cpu, setup["centroids"])
    cpu_codes_equal, cpu_diff = _ida_card_vs_cpu(torch, inp, cpu, setup)

    ok = (launches == n_launches and k1_launches == 0 and shapes == want
          and finite and n_inside > 0 and codes_equal and diff <= MAIN_ATOL
          and feat_diff <= HUBERT_ATOL and voicing_equal
          and f0_rel <= F0_RTOL and cpu_codes_equal and cpu_diff <= CPU_ATOL)
    emit({"phase": "ida_main_f32", "seconds": IDA_SECONDS,
          "mask_samples": IDA_MASK, "tap_layer": IDA_TAP,
          "launches": launches, "expected_launches": n_launches,
          "k1_launches": k1_launches, "shapes": shapes, "finite": finite,
          "units_changed_by_mask": n_inside,
          "kernel_vs_plain_codes_equal": codes_equal,
          "kernel_vs_plain_max_abs": diff, "tolerance": MAIN_ATOL,
          "card_vs_cpu_features_max_abs": feat_diff,
          "features_tolerance": HUBERT_ATOL, "unit_margin_min": margin,
          "f0_voicing_equal": voicing_equal,
          "f0_frames_voiced": gaps["f0_frames_voiced"],
          "f0_frames": gaps["f0_frames"], "f0_voiced_max_rel": f0_rel,
          "f0_tolerance": F0_RTOL,
          "card_vs_cpu_codes_equal": cpu_codes_equal,
          "card_vs_cpu_max_abs": cpu_diff, "cpu_tolerance": CPU_ATOL,
          "ok": ok})
    if not ok:
        raise AssertionError("I_da path check failed")
    del cpu

    timing = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        if dtype != torch.float32:
            inp = _ida_inpainter(torch, setup, dtype)
        dev = [torch.as_tensor(u, device="cuda") for u in utts]
        emb_d = torch.as_tensor(emb, device="cuda")
        inp(dev[0], IDA_MASK, emb=emb_d)             # warm-up
        walls, audio_s = 0.0, 0.0
        for u in dev:
            o = inp(u, IDA_MASK, emb=emb_d)
            seconds = o["audio_gen"].shape[-1] / gcfg.sampling_rate
            walls += o["rtf"] * seconds
            audio_s += seconds
            if not all(bool(torch.isfinite(v.float()).all())
                       for k, v in o.items() if k != "rtf"):
                raise AssertionError(f"{name} I_da path gave non-finite "
                                     "output")
        with torch.inference_mode(), full_f32():
            f0n = torch.zeros(1, 1, frames * 4, device="cuda")
            code = torch.zeros(1, frames, dtype=torch.int64, device="cuda")
            feats = torch.zeros(1, gcfg.in_dim, frames, device="cuda")
            parts = {
                "hubert_ms": cuda_ms(lambda: inp.hubert(
                    dev[0][None], tap_layer=IDA_TAP), 3),
                "f0_ms": cuda_ms(lambda: extract_f0(dev[0]), 3),
                "codegen_ms": cuda_ms(lambda: inp.codegen(
                    code, f0=f0n, emb=emb_d[None]), 3),
                "generator_ms": cuda_ms(lambda: inp.codegen.generator(
                    feats), 3)}
        timing[name] = {"rtf": walls / audio_s,
                        "audio_seconds_per_second": audio_s / walls,
                        **parts}
        emit({"phase": "ida_throughput", "dtype": name,
              "utterances": len(dev), "audio_seconds": audio_s,
              "wall_seconds": walls, **timing[name]})
    stage_T, t = {}, frames
    for i, u in enumerate(gcfg.upsample_rates):
        t *= u
        stage_T[gcfg.upsample_initial_channel // 2 ** (i + 1)] = t
    return {"launches": launches, "T": stage_T,
            "kernel_sizes": gcfg.resblock_kernel_sizes,
            "dilations": gcfg.resblock_dilation_sizes, "setup": setup}


def _step_inputs(rng, C, T, K, torch, dtype, B=1):
    x, w1, b1, w2, b2 = _resblock_inputs(rng, B, C, T, K, 1, torch, dtype)
    return x, w1[0], b1[0], w2[0], b2[0]


def _ida_shapes(path):
    for C, T in path["T"].items():
        for K, dils in zip(path["kernel_sizes"], path["dilations"]):
            for d in dils:
                yield C, T, K, d


def phase_ida_kernel_check(torch, path, name="ida_kernel_check",
                           B=1) -> dict:
    """K2 vs its plain version at every (C, K, d) of a generator's
    ResBlock1 steps (the I_da generator's, V1's for `vocode`, or V1's in
    the GAN trainer's validation sweep), at the path's B and per-stage
    T."""
    from speech_inpainting_torch.ops.resblock import (fused_resblock_step,
                                                      resblock_step_reference)
    rng = np.random.default_rng(SEED)
    worst = {"f32_max_abs_err": 0.0, "bf16_rel_err": 0.0, "shapes": 0}
    for C, T, K, d in _ida_shapes(path):
        f32 = _step_inputs(rng, C, T, K, torch, torch.float32, B)
        err = (fused_resblock_step(*f32, d)
               - pinned(resblock_step_reference, *f32, d)).abs().max().item()
        bf = [a.to(torch.bfloat16) for a in f32]
        got = fused_resblock_step(*bf, d).float()
        want = pinned(resblock_step_reference, *bf, d).float()
        rel = ((got - want).abs().max() / want.abs().max()).item()
        torch.cuda.synchronize()
        ok = err <= F32_ATOL and rel <= BF16_RTOL
        emit({"phase": name, "C": C, "K": K, "dilation": d,
              "B": B, "T": T, "f32_max_abs_err": err, "f32_atol": F32_ATOL,
              "bf16_rel_err": rel, "bf16_rtol": BF16_RTOL, "ok": ok})
        if not ok:
            raise AssertionError(f"fused_resblock_step disagrees at C={C} "
                                 f"K={K} d={d}: f32 {err}, bf16 rel {rel}")
        worst["f32_max_abs_err"] = max(worst["f32_max_abs_err"], err)
        worst["bf16_rel_err"] = max(worst["bf16_rel_err"], rel)
        worst["shapes"] += 1
    emit({"phase": f"{name}_summary", **worst})
    return worst


def phase_ida_kernel_time(torch, path) -> dict:
    """K2, its plain version and the library chain timed at the I_da
    generator's 45 step shapes, summed per vocoder call, per dtype."""
    from speech_inpainting_torch.ops.resblock import (fused_resblock_step,
                                                      resblock_step_reference)
    rng = np.random.default_rng(SEED)
    op = torch.ops.si.resblock_step
    timed = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        tot = {"ms": 0.0, "op_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "bound_ms": 0.0, "bound_fma_ms": 0.0}
        floors = {"operations": 0.0, "bytes": 0.0}
        stages = {}
        for C, T, K, d in _ida_shapes(path):
            args = _step_inputs(rng, C, T, K, torch, dtype)
            ms = cuda_ms(lambda: fused_resblock_step(*args, d), 5)
            tot["op_ms"] += cuda_ms(lambda: op(*args, d), 5)
            plain_ms = cuda_ms(
                lambda: pinned(resblock_step_reference, *args, d), 5)
            lib = library_ms(
                torch, lambda: resblock_step_reference(*args, d), 5)
            t_ops, t_bytes = resblock_bound_ms(1, C, T, K, 1, name)
            row = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib,
                   "bound_ms": max(t_ops, t_bytes)}
            for key, v in row.items():
                tot[key] += v
            tot["bound_fma_ms"] += max(resblock_bound_ms(
                1, C, T, K, 1, name, route=False))
            _stage_sums(stages, C, row)
            floors["operations"] += t_ops
            floors["bytes"] += t_bytes
            emit({"phase": "ida_kernel_time", "dtype": name, "B": 1, "C": C,
                  "T": T, "K": K, "dilation": d, **row,
                  "bound_by": "operations" if t_ops >= t_bytes
                  else "bytes"})
        tot["route"] = _route_us(torch, dtype, step=True)
        tot["bound_by"] = max(floors, key=floors.get)
        tot["by_C"] = stages
        timed[name] = tot
        emit({"phase": "ida_kernel_time_per_vocoder_call", "dtype": name,
              **tot})
    return timed


def _recorded(modules: dict):
    """Forward hooks that keep, for each named module, the float32 outputs
    of its calls (on the CPU): numbers read inside an entry point where
    they are computed. Returns (records, handles)."""
    rec = {k: [] for k in modules}
    handles = [m.register_forward_hook(
        lambda mod, args, out, k=k: rec[k].append(out.detach().float().cpu()))
        for k, m in modules.items()]
    return rec, handles


def _recorded_gap(rec) -> float:
    """The largest gap between the card's and the CPU's recorded outputs,
    call by call."""
    assert len(rec["card"]) == len(rec["cpu"]) > 0
    return max((a - b).abs().max().item()
               for a, b in zip(rec["card"], rec["cpu"]))


def phase_default_flags(torch, main_setup, ida_setup) -> dict:
    """Both entry points under torch's default TF32 flags (cuDNN may run
    float32 convolutions in TF32; cuBLAS may not): they pin full float32
    themselves, so the card-vs-CPU gates of `main` and `ida_main` must hold.
    Gated as well: the HuBERT outputs each entry point computes inside its
    call (read by forward hooks), card vs CPU at HUBERT_ATOL, which TF32 in
    HuBERT's conv stack moves past that tolerance (`--unpinned` shows it).
    The gaps of HuBERT's features and the f0 track called as modules,
    outside an entry point, under these flags are printed beside them (not
    gated: that is what the entry points' pinning is for)."""
    from speech_inpainting_torch.infer.inpaint import InformedInpainter
    from speech_inpainting_torch.testing import synthetic_batch
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32, matmul.allow_tf32 = True, False   # torch's defaults
    hooks = []
    try:
        cfg, hp, gp, centroids = main_setup
        card = InformedInpainter(cfg, hp, gp, centroids)
        cpu = InformedInpainter(cfg, hp, gp, centroids, device="cpu")
        ea_rec, hooks = _recorded({"card": card.hubert, "cpu": cpu.hubert})
        s22, s16, spos, slens = synthetic_batch(
            np.random.default_rng(SEED + 1), 1, 0.5, mask_frames=5)
        a = card.batch(s22, s16, spos, slens)
        b = cpu.batch(s22, s16, spos, slens)
        ea_diff = (a["inpainted"].cpu() - b["inpainted"]).abs().max().item()
        ea_labels = bool(torch.equal(a["pred_labels"].cpu(),
                                     b["pred_labels"]))
        ea_hubert = _recorded_gap(ea_rec)
        for h in hooks:
            h.remove()
        del card, cpu
        inp = _ida_inpainter(torch, ida_setup, torch.float32)
        cpu = _ida_inpainter(torch, ida_setup, torch.float32, device="cpu")
        da_rec, hooks = _recorded({"card": inp.hubert, "cpu": cpu.hubert})
        codes_equal, da_diff = _ida_card_vs_cpu(torch, inp, cpu, ida_setup)
        da_feats = _recorded_gap(da_rec)
        for h in hooks:
            h.remove()
        hooks = []
        unpinned = _module_gaps(torch, inp, cpu, ida_setup["utts"][0])
        flags = {"cudnn_allow_tf32": cudnn.allow_tf32,
                 "matmul_allow_tf32": matmul.allow_tf32}
    finally:
        for h in hooks:
            h.remove()
        cudnn.allow_tf32, matmul.allow_tf32 = saved
    ok = (ea_diff <= CPU_ATOL and ea_labels and ea_hubert <= HUBERT_ATOL
          and codes_equal and da_diff <= CPU_ATOL and da_feats <= HUBERT_ATOL)
    out = {"phase": "default_flags", **flags,
           "ea_card_vs_cpu_max_abs": ea_diff,
           "ea_pred_labels_equal": ea_labels,
           "ea_hubert_head_card_vs_cpu_max_abs": ea_hubert,
           "ida_card_vs_cpu_codes_equal": codes_equal,
           "ida_card_vs_cpu_max_abs": da_diff,
           "ida_features_card_vs_cpu_max_abs": da_feats,
           "cpu_tolerance": CPU_ATOL, "features_tolerance": HUBERT_ATOL,
           "unpinned_modules": unpinned, "ok": ok}
    emit(out)
    if not ok:
        raise AssertionError("an entry point missed a card-vs-CPU gate "
                             "under torch's default TF32 flags")
    return out


# ------------------------------------------------- the I_ea predict path

def _short_inputs(seed=SEED + 1):
    """The card-vs-CPU input: one 0.5 s utterance with a 5-frame mask."""
    from speech_inpainting_torch.testing import synthetic_batch
    return synthetic_batch(np.random.default_rng(seed), 1, 0.5,
                           mask_frames=5)


def _finite(torch, out) -> bool:
    return all(bool(torch.isfinite(v.float()).all()) for v in out.values())


def _timed_batches(torch, inp, dev, iters=5) -> float:
    """Seconds per `inp.batch(*dev)`, host clock, the card synchronised
    before and after `iters` back-to-back batches."""
    inp.batch(*dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        inp.batch(*dev)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters


def _path_check(torch, name, inp, cpu, batch, n_launches) -> dict:
    """One I_ea configuration through its entry point: K1 launches on the
    main batch, shapes and finiteness, kernel path vs plain path (f32
    waveform atol MAIN_ATOL, labels equal), and card vs CPU on the short
    input (HuBERT's head output inside the entry point at HUBERT_ATOL,
    waveform at CPU_ATOL, labels equal)."""
    from speech_inpainting_torch.ops.resblock import fused_resblock1
    gen = inp.generator
    w22, w16, pos, lens = batch
    fused_resblock1.launches = 0
    out = inp.batch(w22, w16, pos, lens)
    torch.cuda.synchronize()
    launches = fused_resblock1.launches
    B = w22.shape[0]
    T_out = (1 + (w22.shape[1] + 2 * 312 - 1024) // 441) * 441 // 256 * 256
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    want = {"inpainted": (B, T_out), "mel_masked": (B, 80, 200),
            "mel_inpainted": (B, 80, 200), "pred_labels": (B, 199)}
    finite = _finite(torch, out)
    gen.use_kernel = False
    plain = inp.batch(w22, w16, pos, lens)
    gen.use_kernel = True
    diff = (out["inpainted"] - plain["inpainted"]).abs().max().item()
    labels = bool(torch.equal(out["pred_labels"], plain["pred_labels"]))
    rec, hooks = _recorded({"card": inp.hubert, "cpu": cpu.hubert})
    try:
        s = _short_inputs()
        a, b = inp.batch(*s), cpu.batch(*s)
        head = _recorded_gap(rec)
    finally:
        for h in hooks:
            h.remove()
    cpu_diff = (a["inpainted"].cpu() - b["inpainted"]).abs().max().item()
    cpu_labels = bool(torch.equal(a["pred_labels"].cpu(), b["pred_labels"]))
    ok = (launches == n_launches and shapes == want and finite
          and diff <= MAIN_ATOL and labels and head <= HUBERT_ATOL
          and cpu_diff <= CPU_ATOL and cpu_labels)
    row = {"phase": name, "B": B, "launches": launches,
           "expected_launches": n_launches, "shapes": shapes,
           "finite": finite, "kernel_vs_plain_max_abs": diff,
           "kernel_vs_plain_labels_equal": labels, "tolerance": MAIN_ATOL,
           "card_vs_cpu_head_max_abs": head, "head_tolerance": HUBERT_ATOL,
           "card_vs_cpu_max_abs": cpu_diff, "cpu_tolerance": CPU_ATOL,
           "card_vs_cpu_labels_equal": cpu_labels, "ok": ok}
    emit(row)
    if not ok:
        raise AssertionError(f"{name} path check failed")
    return row


def phase_ea_large(torch) -> dict:
    """The I_ea path with HuBERT-large (1024 hidden, 24 layers, 16 heads,
    the reference's I_ea encoder) and V1 at full width, B = 4 × 4 s:
    `_path_check`, then bf16 and f32 batch times and the parts'."""
    from speech_inpainting_torch.device import full_f32
    from speech_inpainting_torch.infer.inpaint import (InformedInpainter,
                                                       InpainterConfig)
    from speech_inpainting_torch.models.hifigan import HiFiGANConfig
    from speech_inpainting_torch.models.hubert import HubertConfig
    from speech_inpainting_torch.testing import (generator_tree, hubert_tree,
                                                 synthetic_batch)
    rng = np.random.default_rng(SEED + 10)
    hcfg, gcfg = HubertConfig.large(), HiFiGANConfig()
    hp, gp = hubert_tree(hcfg, 80, rng), generator_tree(gcfg, rng)
    centroids = rng.standard_normal((100, 80)).astype(np.float32)
    cfg = InpainterConfig(hcfg, gcfg)
    batch = synthetic_batch(rng, 4, 4.0)
    inp = InformedInpainter(cfg, hp, gp, centroids)
    cpu = InformedInpainter(cfg, hp, gp, centroids, device="cpu")
    check = _path_check(torch, "ea_large_f32", inp, cpu, batch, 72)
    del cpu
    dev = [torch.as_tensor(a, device="cuda") for a in batch]
    audio_s = 4 * check["shapes"]["inpainted"][1] / 22050.0
    f32_s = _timed_batches(torch, inp, dev)
    inp16 = InformedInpainter(InpainterConfig(
        HubertConfig.large(dtype=torch.bfloat16),
        HiFiGANConfig(dtype=torch.bfloat16)), hp, gp, centroids)
    if not _finite(torch, inp16.batch(*dev)):
        raise AssertionError("bf16 HuBERT-large path gave non-finite output")
    bf16_s = _timed_batches(torch, inp16, dev)
    with torch.inference_mode(), full_f32():
        hub_ms = cuda_ms(lambda: inp16.hubert(dev[1]), 3)
        hub32_ms = cuda_ms(lambda: inp.hubert(dev[1]), 3)
    emit({"phase": "ea_large_throughput", "B": 4, "audio_seconds": audio_s,
          "f32_batch_seconds": f32_s,
          "f32_audio_seconds_per_second": audio_s / f32_s,
          "bf16_batch_seconds": bf16_s,
          "bf16_audio_seconds_per_second": audio_s / bf16_s,
          "bf16_hubert_ms": hub_ms, "f32_hubert_ms": hub32_ms})
    del inp16
    return {"launches": check["launches"], "inp": inp, "cfg": cfg, "hp": hp,
            "gp": gp, "centroids": centroids}


def phase_istft_engine(torch, main_setup) -> dict:
    """`InformedInpainter(generator=ISTFTGenerator)` at the C8C8I geometry,
    width 512 (the trunk is V1's first two stages: 6 ResBlock1s, 36 K1
    launches), with the main path's HuBERT-base: `_path_check`, then its
    vocoder and batch times beside V1's, bf16 and f32, taken in turns."""
    from speech_inpainting_torch.convert.from_jax import (
        istft_generator_from_jax)
    from speech_inpainting_torch.device import full_f32
    from speech_inpainting_torch.infer.inpaint import (InformedInpainter,
                                                       InpainterConfig)
    from speech_inpainting_torch.models.hifigan import HiFiGANConfig
    from speech_inpainting_torch.models.hifigan_istft import (
        ISTFTGeneratorConfig)
    from speech_inpainting_torch.models.hubert import HubertConfig
    from speech_inpainting_torch.testing import (generator_tree,
                                                 synthetic_batch)
    cfg, hp, gp, centroids = main_setup
    rng = np.random.default_rng(SEED + 20)
    icfg = ISTFTGeneratorConfig()
    tree = generator_tree(icfg, rng)
    batch = synthetic_batch(rng, 4, 4.0)

    def engines(dtype):
        hub = HubertConfig.base(dtype=dtype)
        c = InpainterConfig(hub, HiFiGANConfig(dtype=dtype))
        ig = istft_generator_from_jax(
            dataclasses.replace(icfg, dtype=dtype), tree)
        return (InformedInpainter(c, hp, None, centroids, generator=ig),
                InformedInpainter(c, hp, gp, centroids))

    f32 = engines(torch.float32)
    cpu = InformedInpainter(cfg, hp, None, centroids, device="cpu",
                            generator=istft_generator_from_jax(
                                icfg, tree, device="cpu"))
    check = _path_check(torch, "istft_engine_f32", f32[0], cpu, batch, 36)
    del cpu
    dev = [torch.as_tensor(a, device="cuda") for a in batch]
    audio_s = 4 * check["shapes"]["inpainted"][1] / 22050.0
    times = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        inp, v1 = f32 if dtype == torch.float32 else engines(dtype)
        with torch.inference_mode(), full_f32():
            mel = torch.zeros(4, 80, check["shapes"]["inpainted"][1] // 256,
                              device="cuda")
            gen = [cuda_ms(lambda: g.generator(mel), 3)
                   for g in (inp, v1, v1, inp)]
        batches = [_timed_batches(torch, e, dev) for e in (inp, v1, v1, inp)]
        times[name] = {
            "istft_vocoder_ms": (gen[0] + gen[3]) / 2,
            "v1_vocoder_ms": (gen[1] + gen[2]) / 2,
            "istft_batch_seconds": (batches[0] + batches[3]) / 2,
            "v1_batch_seconds": (batches[1] + batches[2]) / 2}
        times[name]["istft_audio_seconds_per_second"] = (
            audio_s / times[name]["istft_batch_seconds"])
        times[name]["v1_audio_seconds_per_second"] = (
            audio_s / times[name]["v1_batch_seconds"])
        emit({"phase": "istft_engine_throughput", "dtype": name, "B": 4,
              "audio_seconds": audio_s, **times[name],
              "order": "istft, v1, v1, istft (means of the two)"})
    return {"launches": check["launches"], "times": times}


def phase_artifacts(torch, main_setup) -> dict:
    """The reference's other artifacts on the card against the CPU, f32,
    atol CPU_ATOL: `hifi_masked` (one utterance) and `batch_expected` (B =
    2, random true labels)."""
    from speech_inpainting_torch.infer.inpaint import InformedInpainter
    from speech_inpainting_torch.testing import synthetic_batch
    cfg, hp, gp, centroids = main_setup
    card = InformedInpainter(cfg, hp, gp, centroids)
    cpu = InformedInpainter(cfg, hp, gp, centroids, device="cpu")
    rng = np.random.default_rng(SEED + 30)
    w22, _, pos, lens = synthetic_batch(rng, 2, 0.5, mask_frames=5)
    labels = rng.integers(0, len(centroids), (2, w22.shape[1] // 441))
    a = card.hifi_masked(w22[0], int(pos[0]), int(lens[0])).cpu()
    b = cpu.hifi_masked(w22[0], int(pos[0]), int(lens[0]))
    hifi = (a - b).abs().max().item()
    a = card.batch_expected(w22, labels, pos, lens)
    b = cpu.batch_expected(w22, labels, pos, lens)
    exp = max((a[k].cpu() - b[k]).abs().max().item() for k in a)
    shapes = {k: tuple(v.shape) for k, v in a.items()}
    ok = hifi <= CPU_ATOL and exp <= CPU_ATOL and _finite(torch, a)
    emit({"phase": "artifacts", "hifi_masked_card_vs_cpu_max_abs": hifi,
          "batch_expected_card_vs_cpu_max_abs": exp, "shapes": shapes,
          "tolerance": CPU_ATOL, "ok": ok})
    if not ok:
        raise AssertionError("artifacts: card and CPU disagree")
    return {"hifi_masked": hifi, "batch_expected": exp}


SERVING_B = 64
SERVING_BATCHES = 8


def _serving_batches(rng, B, n):
    """n numpy batches of B 4 s utterances: one synthetic batch, shifted by
    k frames (at both rates) and with masks moved for batch k."""
    from speech_inpainting_torch.testing import synthetic_batch
    w22, w16, pos, lens = synthetic_batch(rng, B, 4.0)
    return [(np.roll(w22, 441 * k, axis=1), np.roll(w16, 320 * k, axis=1),
             (pos + 7 * k) % 180 + 1, lens) for k in range(n)]


def _uncovered_shapes(torch, covered, Bs, stage_T) -> list:
    """(B, C, T, K, float32) for each V1 stage whose K1 plans at batch size
    B take a (C, co tile, t tile, K) that no earlier check reached, at the
    first B of `Bs` that takes it; `covered` gains those tiles."""
    from speech_inpainting_torch.ops.resblock import _plan
    todo = []
    for B in Bs:
        for C, T in stage_T.items():
            for K in (3, 7, 11):
                tiles = {(C, _plan(B, C, T, K, d)[:2], K) for d in (1, 3, 5)}
                if not tiles <= covered:
                    todo.append((B, C, T, K, torch.float32))
                    covered |= tiles
    return todo


def _k1_checks(torch, todo, phase, seed) -> list:
    """K1 against its plain version at each (B, C, T, K, dtype) of `todo`
    (f32 atol, bf16 rel), inputs drawn on the card."""
    from speech_inpainting_torch.ops.resblock import (fused_resblock1,
                                                      resblock1_reference)
    rows = []
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    for B, C, T, K, dtype in todo:
        # drawn on the card: B = 256's stage has 7.2e8 elements
        scale = 0.5 / math.sqrt(C * K)
        args = [torch.randn(shape, generator=gen, device="cuda") * f
                for shape, f in (((B, C, T), 1.0), ((3, C, C, K), scale),
                                 ((3, C), 0.1), ((3, C, C, K), scale),
                                 ((3, C), 0.1))]
        args = [a.to(dtype) for a in args]
        got = fused_resblock1(*args, (1, 3, 5)).float()
        want = pinned(resblock1_reference, *args, (1, 3, 5)).float()
        err, tol = (got - want).abs().max().item(), F32_ATOL
        if dtype == torch.bfloat16:
            err, tol = err / want.abs().max().item(), BF16_RTOL
        del got, want, args
        row = {"B": B, "C": C, "T": T, "K": K,
               "dtype": str(dtype).split(".")[-1], "err": err,
               "tolerance": tol, "ok": err <= tol}
        emit({"phase": phase, **row})
        if not row["ok"]:
            raise AssertionError(f"fused_resblock1 disagrees at {row}")
        rows.append(row)
    return rows


def _serving_kernel_checks(torch, covered) -> list:
    """K1 against its plain version at every (C, co tile, t tile, K) that
    the serving batches' plans take and no earlier check reached (f32 atol,
    bf16 rel), at the first serving batch size that takes it; and at
    B = 256's largest stage (C = 32, T = 88 064, K = 11, bf16)."""
    todo = _uncovered_shapes(torch, covered, (SERVING_B, 256),
                             _v1_stage_T(344))
    todo.append((256, 32, 88064, 11, torch.bfloat16))
    return _k1_checks(torch, todo, "serving_kernel_check", SEED + 40)


def _covered_tiles(path) -> set:
    """(C, (co tile, t tile), K) of every K1 launch that the earlier checks
    hold against the plain version: `kernel_check`, the main path's shapes
    (`kernel_time`) and the edge shapes."""
    from speech_inpainting_torch.ops.resblock import _plan
    shapes = [(2, C, 2049, K) for C in (256, 128, 64, 32) for K in (3, 7, 11)]
    shapes += [(4, C, T, K) for C, T in path["T"].items()
               for K in path["kernel_sizes"]]
    shapes += EDGE_SHAPES
    return {(C, _plan(B, C, T, K, d)[:2], K) for B, C, T, K in shapes
            for d in (1, 3, 5)}


def _v1_stage_T(frames) -> dict:
    """V1's ResBlock1 time length per stage C for `frames` mel frames."""
    out, t = {}, frames
    for i, u in enumerate((8, 8, 2, 2)):
        t *= u
        out[256 // 2 ** i] = t
    return out


def phase_serving(torch, main_setup, covered) -> dict:
    """`bench.py`'s flagship (HuBERT-base + V1) in bf16 at B = 64: eight
    numpy batches through a per-batch synchronised loop, then through
    `PipelinedRunner` at depth 1 and at depth 4, twice each in turns (d1,
    d4, d4, d1; d4 once more with the results brought to pinned host
    memory): every output equal to the loop's; audio-s/s of each. Then one
    batch at B = 256 (bench.py:122): finite, its time and peak memory; and
    K1 against its plain version at the plans' new tiles."""
    from speech_inpainting_torch.infer.inpaint import (InformedInpainter,
                                                       InpainterConfig)
    from speech_inpainting_torch.infer.serving import PipelinedRunner, to_host
    from speech_inpainting_torch.models.hifigan import HiFiGANConfig
    from speech_inpainting_torch.models.hubert import HubertConfig
    from speech_inpainting_torch.ops.resblock import fused_resblock1
    _, hp, gp, centroids = main_setup
    inp = InformedInpainter(InpainterConfig(
        HubertConfig.base(dtype=torch.bfloat16),
        HiFiGANConfig(dtype=torch.bfloat16)), hp, gp, centroids)
    batches = _serving_batches(np.random.default_rng(SEED + 50), SERVING_B,
                               SERVING_BATCHES)
    audio_s = SERVING_B * 88064 / 22050.0      # per batch
    inp.batch(*batches[0])                     # warm-up at this shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = []
    for b in batches:
        out = inp.batch(*b)
        torch.cuda.synchronize()
        want.append(out)
    loop_s = time.perf_counter() - t0
    runs, equal, launches = [], True, {}
    for depth, fetch in ((1, None), (4, None), (4, None), (1, None),
                         (4, to_host)):
        fused_resblock1.launches = 0
        runner = PipelinedRunner(inp.batch, depth=depth, fetch=fetch)
        got = list(runner.map(batches))
        rate = runner.throughput(audio_s)
        name = f"depth{depth}" + ("_to_host" if fetch else "")
        launches[name] = fused_resblock1.launches
        same = len(got) == len(want) and all(
            torch.equal(g[k].to(w[k].device), w[k])
            for g, w in zip(got, want) for k in w)
        equal = equal and same
        runs.append({"run": name, "audio_seconds_per_second": rate,
                     "seconds": runner.elapsed, "equal_to_loop": same})
        emit({"phase": "serving_run", "B": SERVING_B,
              "batches": SERVING_BATCHES, **runs[-1],
              "k1_launches": launches[name]})
        del got
    rates = {n: [r["audio_seconds_per_second"] for r in runs
                 if r["run"] == n] for n in ("depth1", "depth4")}
    del want
    # one batch at bench.py's B = 256: the B = 64 batch four times over
    big = [np.concatenate([a] * 4) for a in batches[0]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = inp.batch(*big)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = inp.batch(*big)
    torch.cuda.synchronize()
    b256_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    b256_ok = _finite(torch, out) and tuple(out["inpainted"].shape) == (
        256, 88064)
    del out
    checks = _serving_kernel_checks(torch, covered)
    ok = equal and b256_ok and all(
        v == 72 * SERVING_BATCHES for v in launches.values())
    row = {"phase": "serving", "B": SERVING_B, "batches": SERVING_BATCHES,
           "audio_seconds_per_batch": audio_s,
           "sync_loop_audio_seconds_per_second":
               SERVING_BATCHES * audio_s / loop_s,
           "depth1_audio_seconds_per_second": rates["depth1"],
           "depth4_audio_seconds_per_second": rates["depth4"],
           "outputs_equal_to_loop": equal, "k1_launches": launches,
           "b256_batch_seconds": b256_s,
           "b256_audio_seconds_per_second": 256 * 88064 / 22050.0 / b256_s,
           "b256_peak_memory_bytes": peak, "b256_finite": b256_ok,
           "kernel_checks": len(checks), "ok": ok}
    emit(row)
    if not ok:
        raise AssertionError("serving check failed")
    return {"launches": launches["depth4"], "row": row}


def phase_longform(torch, main_setup) -> dict:
    """`LongFormInpainter` over a 60 s synthetic recording with 5 masks of
    10 frames, two of them 2 frames apart (merged into one window), window
    4 s, batch 8, depth 4, f32: output bit-equal to the input outside the
    pasted spans, equal (atol MAIN_ATOL) to the same windows run one
    direct `batch` call each and pasted alike, and the card against the
    CPU (atol CPU_ATOL)."""
    from speech_inpainting_torch.infer.inpaint import InformedInpainter
    from speech_inpainting_torch.infer.longform import (LongFormConfig,
                                                        LongFormInpainter)
    from speech_inpainting_torch.ops.resblock import fused_resblock1
    from speech_inpainting_torch.testing import synthetic_batch
    cfg, hp, gp, centroids = main_setup
    w22, w16, _, _ = synthetic_batch(np.random.default_rng(SEED + 60), 1,
                                     60.0)
    w22, w16 = w22[0], w16[0]
    pos, lens = [400, 1200, 1212, 2000, 2800], [10] * 5
    lcfg = LongFormConfig(window_frames=200, batch=8, depth=4)
    inp = InformedInpainter(cfg, hp, gp, centroids)
    lf = LongFormInpainter(inp, lcfg)
    lf(w22, w16, pos, lens)                    # warm-up at this shape
    fused_resblock1.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, spans = lf(w22, w16, pos, lens)
    seconds = time.perf_counter() - t0
    launches = fused_resblock1.launches
    outside = np.ones(len(out), bool)
    for a, b in spans:
        outside[a:b] = False
    untouched = bool(np.array_equal(out[outside], w22[outside]))
    job = lf.plan(w22, w16, pos, lens)
    for i0 in job.starts:
        args, gains = job.window_batch(i0)
        job.paste(inp.batch(*args)["inpainted"].cpu().numpy(), i0, gains)
    direct = float(np.abs(out - job.out).max())
    on_cpu, cpu_spans = LongFormInpainter(InformedInpainter(
        cfg, hp, gp, centroids, device="cpu"), lcfg)(w22, w16, pos, lens)
    cpu_diff = float(np.abs(out - on_cpu).max())
    ok = (len(spans) == 4 and launches == 72 and untouched
          and direct <= MAIN_ATOL and cpu_spans == spans
          and cpu_diff <= CPU_ATOL and not np.array_equal(out, w22))
    emit({"phase": "longform", "seconds_of_audio": len(w22) / 22050.0,
          "masks": len(pos), "windows": len(spans), "launches": launches,
          "wall_seconds": seconds, "untouched_outside_spans": untouched,
          "vs_direct_batch_max_abs": direct, "tolerance": MAIN_ATOL,
          "card_vs_cpu_max_abs": cpu_diff, "cpu_tolerance": CPU_ATOL,
          "ok": ok})
    if not ok:
        raise AssertionError("long-form check failed")
    return {"launches": launches, "seconds": seconds}


def phase_cli(torch, large) -> dict:
    """`predict_ea.main` on the card, as a user runs it, on files written
    to a temporary directory: a synthetic 4 s wav, the HuBERT-large
    `CustomModel` state dict and the V1 `g_*` file of `ea_large`'s weights
    (the reference's layouts, from testing.py), its codebook as .npy and
    true labels. Every artifact is written (the mel PNGs where matplotlib
    is installed); inpainted.wav equals `ea_large`'s inpainter on the same
    weights and wav to 1 int16 step; `--long-form` with two masks."""
    import importlib.util
    import tempfile
    from scipy.io import wavfile
    from speech_inpainting_torch.cli import predict_ea
    from speech_inpainting_torch.data.audio import load_wav, save_wav
    from speech_inpainting_torch.ops.resblock import fused_resblock1
    from speech_inpainting_torch.testing import (custom_model_state_dict,
                                                 generator_state_dict,
                                                 synthetic_batch)
    figures = importlib.util.find_spec("matplotlib") is not None
    rng = np.random.default_rng(SEED + 70)
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        w22 = synthetic_batch(rng, 1, 4.0)[0][0]
        wavfile.write(d / "utt.wav", 22050, (w22 * 32767).astype(np.int16))
        torch.save(custom_model_state_dict(large["hp"], large["cfg"].hubert),
                   d / "best.pt")
        torch.save({"generator": generator_state_dict(
            large["gp"], large["cfg"].hifigan)}, d / "g_00000001")
        np.save(d / "km.npy", large["centroids"])
        np.save(d / "labels.npy", rng.integers(0, 100, 200))
        common = ["--wav", str(d / "utt.wav"), "--hubert-checkpoint",
                  str(d / "best.pt"), "--hubert-type", "large",
                  "--hifigan-checkpoint", str(d / "g_00000001"),
                  "--kmeans", str(d / "km.npy"), "--device", "cuda"]
        fused_resblock1.launches = 0
        t0 = time.perf_counter()
        predict_ea.main(common + ["--start-sec", "1.5", "--end-sec", "1.7",
                                  "--labels", str(d / "labels.npy"),
                                  "--out", str(d / "one")], figures=figures)
        seconds = time.perf_counter() - t0
        launches = fused_resblock1.launches
        art = d / "one" / "utt"
        names = ["orig.wav", "masked.wav", "hifi_masked.wav",
                 "inpainted.wav", "expected_inpaint.wav"]
        if figures:
            names += ["masked.png", "inpainted.png", "expected.png"]
        written = sorted(p.name for p in art.iterdir())
        # the same weights and wav through the inpainter directly
        wav22, _ = load_wav(d / "utt.wav", 22050)
        wav16, _ = load_wav(d / "utt.wav", 16000)
        direct = large["inp"](wav22, wav16, 75, 10)["inpainted"]
        save_wav(d / "direct.wav", direct.cpu().numpy(), 22050)
        _, a = wavfile.read(art / "inpainted.wav")
        _, b = wavfile.read(d / "direct.wav")
        steps = int(np.abs(a.astype(np.int32) - b).max())
        predict_ea.main(common + ["--long-form", "--mask", "0.5-0.7",
                                  "--mask", "2.5-2.7", "--out",
                                  str(d / "long")], figures=figures)
        long_dir = d / "long" / "utt"
        spans = json.loads((long_dir / "spans.json").read_text())
        long_ok = all((long_dir / n).exists() for n in
                      ("orig.wav", "masked.wav", "inpainted.wav")) and len(
            spans["pasted_sample_spans"]) == 2
    ok = (set(names) <= set(written) and steps <= 1 and long_ok
          and launches == 3 * 72)
    emit({"phase": "cli", "figures": figures, "written": written,
          "inpainted_vs_direct_int16_steps": steps, "launches": launches,
          "expected_launches": 3 * 72, "seconds": seconds,
          "long_form_spans": spans["pasted_sample_spans"], "ok": ok})
    if not ok:
        raise AssertionError("predict_ea CLI check failed")
    return {"launches": launches}


# ------------------------------------------------- the serving artifact

AOT_SECONDS = 4.0
AOT_BATCHES = (4, 8)
AOT_PLAIN_ATOL = 1e-5  # the plain-Generator artifact against the live call
INT8_RTOL = 0.1    # int8 HuBERT-base against f32, relative norm error: the
#                    random-weight encoder carries float32 rounding, through
#                    int8 code flips, to a few 1e-2 of its output (the card
#                    against the CPU on one input reads as much); a broken
#                    quantizer reads ~1
# the loaded artifacts run in a process that cannot import the port's
# models, converters or live inpainter (nor JAX): argv is the directory of
# the artifacts and their inputs, then the artifacts' names, each with
# ":B" where it runs at that batch size alone; K1's and K2's launches are
# counted apart
AOT_CHILD = r"""
import json, sys, time
import numpy as np
for name in ("jax", "speech_inpainting_tpu", "speech_inpainting_torch.models",
             "speech_inpainting_torch.convert",
             "speech_inpainting_torch.infer.inpaint"):
    sys.modules[name] = None
import torch
from pathlib import Path
from speech_inpainting_torch.infer.aot import load_serving_artifact
from speech_inpainting_torch.ops.resblock import (fused_resblock1,
                                                  fused_resblock_step)
d, names = Path(sys.argv[1]), sys.argv[2:]
x = np.load(d / "inputs.npz")
out = {}
for spec in names:
    name, _, only = spec.partition(":")
    t0 = time.perf_counter()
    art = load_serving_artifact(d / name)
    torch.cuda.synchronize()
    row = {"load_s": time.perf_counter() - t0, "runs": {}}
    for B in sorted(int(k[3:]) for k in x.files if k.startswith("w22")):
        if only and B != int(only):
            continue
        args = [x[f"{k}{B}"] for k in ("w22", "w16", "pos", "lens")]
        fused_resblock1.launches = fused_resblock_step.launches = 0
        res = art.batch(*args)
        torch.cuda.synchronize()
        launches = fused_resblock1.launches
        k2_launches = fused_resblock_step.launches
        np.savez(d / f"{name}_{B}.npz",
                 **{k: v.float().cpu().numpy() if k != "pred_labels"
                    else v.cpu().numpy() for k, v in res.items()})
        dev = [torch.as_tensor(a, device="cuda") for a in args]
        art.batch(*dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            art.batch(*dev)
        torch.cuda.synchronize()
        row["runs"][B] = {"launches": launches, "k2_launches": k2_launches,
                          "batch_s": (time.perf_counter() - t0) / 5}
    out[name] = row
    del art
print(json.dumps(out))
"""


def _aot_gap(torch, got: dict, live: dict, dtype) -> tuple[float, bool]:
    """The artifact's waveform against the live one (max abs in f32,
    relative to the live peak in bf16) and whether the labels are equal."""
    want = live["inpainted"].float().cpu().numpy()
    err = float(np.abs(got["inpainted"] - want).max())
    if dtype == torch.bfloat16:
        err /= float(np.abs(want).max())
    return err, bool(np.array_equal(got["pred_labels"],
                                    live["pred_labels"].cpu().numpy()))


def phase_aot_export(torch, main_setup, d: Path) -> dict:
    """The serving artifact at the main path's full width (HuBERT-base +
    head, the 100×80 codebook, V1; 4 s utterances) in f32 and bf16, and
    once with the iSTFT engine (C8C8I, width 512) as the generator
    override: each exported batch-polymorphic on the card and saved, then
    loaded and run at B = 4 and 8 in a child process that cannot import
    the port's models, converters or live inpainter; its waveforms against
    the live `InformedInpainter.batch` (f32 atol MAIN_ATOL, bf16 rel
    BF16_RTOL), labels equal, K1 launches per batch (72 for V1, 36 for the
    engine); export, load and batch times beside the live batch's. Then
    `aot_plain_generator`: the same f32 inpainter with the plain
    models/hifigan.py `Generator` as the override, whose traced ResBlock1s
    call K2's operator `si::resblock_step`, exported the same way and run
    at B = 4 alone in the same child process: 72 K2 launches (and no K1)
    per batch, waveform within AOT_PLAIN_ATOL of the live call, labels
    equal."""
    from speech_inpainting_torch.convert.from_jax import (
        generator_from_jax, istft_generator_from_jax)
    from speech_inpainting_torch.infer.aot import save_serving_artifact
    from speech_inpainting_torch.infer.inpaint import (InformedInpainter,
                                                       InpainterConfig)
    from speech_inpainting_torch.models.hifigan import (Generator,
                                                        HiFiGANConfig)
    from speech_inpainting_torch.models.hifigan_istft import (
        ISTFTGeneratorConfig)
    from speech_inpainting_torch.models.hubert import HubertConfig
    from speech_inpainting_torch.testing import (generator_tree,
                                                 synthetic_batch)
    cfg, hp, gp, centroids = main_setup
    rng = np.random.default_rng(SEED + 80)
    batches = {B: synthetic_batch(rng, B, AOT_SECONDS) for B in AOT_BATCHES}
    np.savez(d / "inputs.npz", **{
        f"{k}{B}": v for B, x in batches.items()
        for k, v in zip(("w22", "w16", "pos", "lens"), x)})
    t22, t16 = (a.shape[1] for a in batches[AOT_BATCHES[0]][:2])
    bf = InpainterConfig(HubertConfig.base(dtype=torch.bfloat16),
                         HiFiGANConfig(dtype=torch.bfloat16))
    icfg = ISTFTGeneratorConfig()
    engines = {
        "v1_float32": (InformedInpainter(cfg, hp, gp, centroids),
                       torch.float32, 72),
        "v1_bfloat16": (InformedInpainter(bf, hp, gp, centroids),
                        torch.bfloat16, 72),
        "istft_float32": (InformedInpainter(
            cfg, hp, None, centroids, generator=istft_generator_from_jax(
                icfg, generator_tree(icfg, rng))), torch.float32, 36)}
    plain = InformedInpainter(cfg, hp, None, centroids,
                              generator=generator_from_jax(
                                  cfg.hifigan, gp, cls=Generator))
    t0 = time.perf_counter()
    save_serving_artifact(d / "v1_plain_generator", plain, t22, t16)
    plain_export_s = time.perf_counter() - t0
    rows = {}
    for name, (inp, dtype, n) in engines.items():
        t0 = time.perf_counter()
        meta = save_serving_artifact(d / name, inp, t22, t16)
        rows[name] = {"export_s": time.perf_counter() - t0,
                      "poly": meta["poly"], "stored_on": meta["stored_on"],
                      "graph_mb": (d / name / "graph.pt2").stat().st_size
                      / 2**20}
        if "poly_export_error" in meta:
            rows[name]["poly_export_error"] = meta["poly_export_error"]
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", AOT_CHILD, str(d),
                          *engines, f"v1_plain_generator:{AOT_BATCHES[0]}"],
                         cwd=Path(__file__).resolve().parent,
                         capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"aot_export child failed:\n{res.stderr[-4000:]}")
    child = json.loads(res.stdout.strip().splitlines()[-1])
    ok = True
    for name, (inp, dtype, n) in engines.items():
        row = rows[name]
        row["load_s"] = child[name]["load_s"]
        tol = BF16_RTOL if dtype == torch.bfloat16 else MAIN_ATOL
        for B, x in batches.items():
            run = child[name]["runs"][str(B)]
            live = inp.batch(*x)
            got = dict(np.load(d / f"{name}_{B}.npz"))
            err, labels = _aot_gap(torch, got, live, dtype)
            dev = [torch.as_tensor(a, device="cuda") for a in x]
            live_s = _timed_batches(torch, inp, dev)
            audio_s = B * got["inpainted"].shape[1] / 22050.0
            good = (run["launches"] == n and err <= tol and labels
                    and np.isfinite(got["inpainted"]).all())
            ok &= bool(good)
            row[f"B{B}"] = {
                "launches": run["launches"], "expected_launches": n,
                "vs_live": err, "tolerance": tol, "labels_equal": labels,
                "artifact_batch_ms": 1e3 * run["batch_s"],
                "live_batch_ms": 1e3 * live_s,
                "artifact_audio_seconds_per_second": audio_s / run["batch_s"],
                "live_audio_seconds_per_second": audio_s / live_s,
                "ok": bool(good)}
        emit({"phase": "aot_export", "artifact": name, **row})
    emit({"phase": "aot_export_child", "seconds": child_s,
          "note": "one process: imports, four loads, the runs"})
    if not ok or not all(r["poly"] for r in rows.values()):
        raise AssertionError("aot_export: the artifact and the live "
                             "inpainter disagree, or the export is static")
    B = AOT_BATCHES[0]
    t0 = time.perf_counter()
    run = child["v1_plain_generator"]["runs"][str(B)]
    got = dict(np.load(d / f"v1_plain_generator_{B}.npz"))
    err, labels = _aot_gap(torch, got, plain.batch(*batches[B]),
                           torch.float32)
    dev = [torch.as_tensor(a, device="cuda") for a in batches[B]]
    live_s = _timed_batches(torch, plain, dev)
    audio_s = B * got["inpainted"].shape[1] / 22050.0
    plain_ok = (run["k2_launches"] == 72 and run["launches"] == 0
                and err <= AOT_PLAIN_ATOL and labels
                and bool(np.isfinite(got["inpainted"]).all()))
    emit({"phase": "aot_plain_generator", "B": B, "export_s": plain_export_s,
          "load_s": child["v1_plain_generator"]["load_s"],
          "k2_launches": run["k2_launches"], "expected_k2_launches": 72,
          "k1_launches": run["launches"], "vs_live": err,
          "tolerance": AOT_PLAIN_ATOL, "labels_equal": labels,
          "artifact_batch_ms": 1e3 * run["batch_s"],
          "live_batch_ms": 1e3 * live_s,
          "artifact_audio_seconds_per_second": audio_s / run["batch_s"],
          "live_audio_seconds_per_second": audio_s / live_s,
          "seconds": plain_export_s + time.perf_counter() - t0,
          "seconds_note": "export and the checks here; its load and run "
                          "are in the child's seconds",
          "ok": plain_ok})
    if not plain_ok:
        raise AssertionError("aot_plain_generator: the exported plain "
                             "Generator's artifact disagrees with the live "
                             "call or missed K2")
    return {"launches": {name: rows[name][f"B{B}"]["launches"]
                         for name in rows},
            "k2_launches": run["k2_launches"]}


def phase_export_aot_cli(torch, main_setup, d: Path) -> dict:
    """`export_aot.main` on the card, as a user runs it, on files written
    as `cli` writes them (a HuBERT-base `CustomModel` state dict, the V1
    `g_*` file and the .npy codebook of the main path's weights), 1 s
    utterances, `--platforms cuda,cpu` (stored on the CPU, moved to the
    card at load): its artifact equal to a direct `save_serving_artifact`
    of the same inpainter on the card at B = 2 (atol 1e-6, labels equal),
    within MAIN_ATOL of the live batch, 72 K1 launches per batch; the same
    artifact loaded on the CPU within CPU_ATOL of the card at B = 1."""
    import argparse
    from speech_inpainting_torch.cli import export_aot, predict_ea
    from speech_inpainting_torch.infer.aot import (load_serving_artifact,
                                                   save_serving_artifact)
    from speech_inpainting_torch.ops.resblock import fused_resblock1
    from speech_inpainting_torch.testing import (custom_model_state_dict,
                                                 generator_state_dict,
                                                 synthetic_batch)
    cfg, hp, gp, centroids = main_setup
    torch.save(custom_model_state_dict(hp, cfg.hubert), d / "best.pt")
    torch.save({"generator": generator_state_dict(gp, cfg.hifigan)},
               d / "g_00000001")
    np.save(d / "km.npy", centroids)
    files = {"hubert_checkpoint": str(d / "best.pt"), "hubert_type": "base",
             "hifigan_checkpoint": str(d / "g_00000001"),
             "hifigan_config": None, "kmeans": str(d / "km.npy"),
             "device": "cuda"}
    t0 = time.perf_counter()
    meta = export_aot.main([
        "--seconds", "1", "--hubert-checkpoint", files["hubert_checkpoint"],
        "--hubert-type", "base", "--hifigan-checkpoint",
        files["hifigan_checkpoint"], "--kmeans", files["kmeans"],
        "--platforms", "cuda,cpu", "--out", str(d / "cli_art"),
        "--device", "cuda"])
    cli_s = time.perf_counter() - t0
    inp = predict_ea.load_inpainter(argparse.Namespace(**files))
    save_serving_artifact(d / "direct_art", inp, 22050, 16000,
                          platforms=["cuda", "cpu"])
    t0 = time.perf_counter()
    art = load_serving_artifact(d / "cli_art")
    load_s = time.perf_counter() - t0
    direct = load_serving_artifact(d / "direct_art")
    x = synthetic_batch(np.random.default_rng(SEED + 90), 2, 1.0,
                        mask_frames=5)
    fused_resblock1.launches = 0
    got = art.batch(*x)
    torch.cuda.synchronize()
    launches = fused_resblock1.launches
    want, live = direct.batch(*x), inp.batch(*x)
    vs_direct = (got["inpainted"] - want["inpainted"]).abs().max().item()
    vs_live = (got["inpainted"] - live["inpainted"]).abs().max().item()
    labels = bool(torch.equal(got["pred_labels"], want["pred_labels"])
                  and torch.equal(got["pred_labels"], live["pred_labels"]))
    del art, direct
    t0 = time.perf_counter()
    on_cpu = load_serving_artifact(d / "cli_art", device="cpu")
    cpu_load_s = time.perf_counter() - t0
    one = [a[:1] for a in x]
    c = on_cpu.batch(*one)
    cpu_gap = (c["inpainted"] - got["inpainted"][:1].cpu()).abs().max(
        ).item()
    cpu_labels = bool(torch.equal(c["pred_labels"],
                                  got["pred_labels"][:1].cpu()))
    ok = (meta["poly"] and meta["stored_on"] == "cpu" and launches == 72
          and vs_direct <= 1e-6 and vs_live <= MAIN_ATOL and labels
          and cpu_gap <= CPU_ATOL and cpu_labels)
    emit({"phase": "export_aot_cli", "meta": meta, "cli_seconds": cli_s,
          "load_cuda_seconds": load_s, "load_cpu_seconds": cpu_load_s,
          "launches": launches, "expected_launches": 72,
          "vs_direct_export_max_abs": vs_direct, "vs_live_max_abs": vs_live,
          "tolerance": MAIN_ATOL, "labels_equal": labels,
          "cpu_vs_card_max_abs": cpu_gap, "cpu_tolerance": CPU_ATOL,
          "cpu_labels_equal": cpu_labels, "ok": ok})
    if not ok:
        raise AssertionError("export_aot CLI check failed")
    return {"launches": launches}


def phase_int8_hubert(torch, main_setup) -> dict:
    """The int8 serving option at HuBERT-base's full width (+ head, the
    main path's weights), B = 4 × 4 s: int8 against f32 by tests/
    test_int8.py's relative norm error (INT8_RTOL), int8 in bf16 the same;
    the card against the CPU on a 0.5 s input (reported, held to
    INT8_RTOL); `dynamic_int8_dot` card against CPU at one padded shape
    and at the FFN's (rtol 1e-6: the same codes, exact int32 sums, the same
    float32 rescale); ms per forward, int8 beside f32 and bf16, in
    turns."""
    import dataclasses as dc
    from speech_inpainting_torch.convert.from_jax import hubert_from_jax
    from speech_inpainting_torch.device import full_f32
    from speech_inpainting_torch.ops.int8 import dynamic_int8_dot
    from speech_inpainting_torch.testing import synthetic_batch
    cfg, hp, _, _ = main_setup
    base = cfg.hubert
    rng = np.random.default_rng(SEED + 100)
    wav = torch.as_tensor(synthetic_batch(rng, 4, 4.0)[1], device="cuda")
    models = {name: hubert_from_jax(dc.replace(base, **over), hp, 80)
              for name, over in (
                  ("float32", {}), ("bfloat16", {"dtype": torch.bfloat16}),
                  ("int8", {"int8": True}),
                  ("int8_bfloat16", {"int8": True,
                                     "dtype": torch.bfloat16}))}
    rel = lambda a, b: (torch.linalg.norm(a.float() - b.float())
                        / torch.linalg.norm(b.float())).item()
    with torch.inference_mode(), full_f32():
        out = {name: m(wav).float() for name, m in models.items()}
        gaps = {name: rel(out[name], out["float32"])
                for name in ("bfloat16", "int8", "int8_bfloat16")}
        order = ("float32", "bfloat16", "int8", "int8_bfloat16")
        t = {name: [] for name in order}
        for name in order + order[::-1]:
            t[name].append(cuda_ms(lambda: models[name](wav), 3))
        ms = {name: sum(v) / 2 for name, v in t.items()}
        short = torch.as_tensor(_short_inputs()[1])
        cpu = hubert_from_jax(dc.replace(base, int8=True), hp, 80,
                              device="cpu")
        card_cpu = rel(models["int8"](short.cuda()).cpu(), cpu(short))
        dots = {}
        for M, K, N in ((5, 20, 12), (4 * 199, 768, 3072)):
            x = rng.standard_normal((M, K)).astype(np.float32)
            w = rng.standard_normal((K, N)).astype(np.float32)
            a = dynamic_int8_dot(torch.tensor(x, device="cuda"),
                                 torch.tensor(w, device="cuda")).cpu()
            b = dynamic_int8_dot(torch.tensor(x), torch.tensor(w))
            dots[f"{M}x{K}x{N}"] = ((a - b).abs() / b.abs().clamp(
                min=1e-30)).max().item()
    ok = (gaps["int8"] < INT8_RTOL and gaps["int8_bfloat16"] < INT8_RTOL
          and card_cpu < INT8_RTOL and max(dots.values()) <= 1e-6
          and all(bool(torch.isfinite(v).all()) for v in out.values()))
    emit({"phase": "int8_hubert", "B": 4, "seconds": 4.0,
          "rel_vs_f32": gaps, "tolerance": INT8_RTOL,
          "card_vs_cpu_rel_int8_0_5s": card_cpu,
          "int8_dot_card_vs_cpu_max_rel": dots, "ms_per_forward": ms,
          "ok": ok})
    if not ok:
        raise AssertionError("int8 HuBERT check failed")
    return {"ms": ms, "gaps": gaps}


# ------------------------------------------ the I_da paths as users run them

CONFIGS = Path(__file__).resolve().parent / "configs"
GAN_CONFIG = CONFIGS / "hifigan_ft_modified.json"
IDA_CLI_MASKS_MS = (100, 200, 300, 400)    # inpaint_da's default masks
# tests/test_codegen.py:144-160's content-VQ geometry (no content-VQ config
# file is in the repository) with the generator 64 wide, not 16: K2 takes
# C in multiples of 16, and 16 would give stages of 8 and 4 channels
CONTENT_VQ = {
    "resblock": "1", "upsample_rates": [2, 2], "upsample_kernel_sizes": [4, 4],
    "upsample_initial_channel": 64, "resblock_kernel_sizes": [3],
    "resblock_dilation_sizes": [[1, 3]], "model_in_dim": 16,
    "sampling_rate": 16000, "num_embeddings": 6, "embedding_dim": 16,
    "lambda_commit_code": 1.0,
    "code_encoder_params": {"input_emb_width": 1, "output_emb_width": 16,
                            "levels": 1, "downs_t": [2], "strides_t": [2],
                            "width": 8, "depth": 1,
                            "dilation_growth_rate": 3},
    "code_vq_params": {"l_bins": 6, "emb_width": 16}}
KMEANS_ROWS, KMEANS_DIM, KMEANS_K = 200_000, 768, 100


def _spread_rows(frames: np.ndarray, n: int) -> np.ndarray:
    """n rows of `frames`, each the farthest from those chosen before it
    (the first the farthest from their mean): a codebook with no two rows
    from one region, as training leaves one. Random rows would often take
    two frames of one silence, and every silent frame would then lie on a
    tie between them."""
    chosen = [int(np.argmax(((frames - frames.mean(0)) ** 2).sum(1)))]
    d = ((frames - frames[chosen[0]]) ** 2).sum(1)
    for _ in range(n - 1):
        chosen.append(int(np.argmax(d)))
        d = np.minimum(d, ((frames - frames[chosen[-1]]) ** 2).sum(1))
    return frames[chosen]


def _write_wav(path, wav, sr) -> None:
    from scipy.io import wavfile
    wavfile.write(path, sr, (np.asarray(wav) * 32767).astype(np.int16))


def _int16_steps(a, b) -> int:
    from scipy.io import wavfile
    x, y = wavfile.read(a)[1], wavfile.read(b)[1]
    if x.shape != y.shape:
        return 1 << 16
    return int(np.abs(x.astype(np.int32) - y).max())


def _ida_files(torch, setup: dict, d: Path) -> None:
    """The full-width I_da stack of `setup` as a user's files in `d`: a
    reference-layout CodeGenerator `g_00400000` ({"generator": sd},
    weight_g / weight_v, emb_c, emb_p, fo_vqvae.* with the f0-VQ-VAE's
    decoder, which the reference's files carry), an HF HuBERT-base
    directory `hubert-base` (config.json + pytorch_model.bin) and the
    codebook `km.npy`."""
    from speech_inpainting_torch.models.hubert import HubertConfig
    from speech_inpainting_torch.testing import (code_generator_state_dict,
                                                 jukebox_tree,
                                                 write_hf_hubert)
    cfg = setup["cfg"]
    rng = np.random.default_rng(SEED + 80)
    params = dict(setup["params"], fo_vqvae=dict(
        setup["params"]["fo_vqvae"], decoder=jukebox_tree(
            cfg.f0_quantizer.decoder, rng, decoder=True)))
    torch.save({"generator": code_generator_state_dict(
        params, setup["vq"], cfg)}, d / "g_00400000")
    write_hf_hubert(d / "hubert-base", setup["hp"], HubertConfig.base())
    np.save(d / "km.npy", setup["centroids"])


def phase_ida_cli(torch, ida) -> dict:
    """`inpaint_da.main` on the card as a user runs it, at full width
    (configs/da_hubert100_lut.json, HuBERT-base tapped at layer 6, the
    100×768 codebook of `ida_main`), on files written to a temporary
    directory: two synthetic 4 s 16 kHz wavs and a JSON-lines manifest, a
    reference-layout CodeGenerator `g_*` ({"generator": sd}, weight_g /
    weight_v, emb_c, emb_p, fo_vqvae.*), an HF HuBERT-base directory
    (config.json + pytorch_model.bin) and a .npy codebook. Masks 100-400
    ms: every artifact written, K2's launches (180 per utterance per
    mask), `_inpainted_200.wav` within 1 int16 step of a direct
    `IdaInpainter` call on the same trees, the median RTF."""
    import tempfile
    from speech_inpainting_torch.cli import inpaint_da
    from speech_inpainting_torch.data.audio import load_wav, save_wav
    from speech_inpainting_torch.data.code_dataset import mel_stats_embedder
    from speech_inpainting_torch.data.manifests import write_manifest
    from speech_inpainting_torch.ops.resblock import fused_resblock_step
    setup = ida["setup"]
    cfg = setup["cfg"]
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        entries = []
        for i, u in enumerate(setup["utts"][:2]):
            _write_wav(d / f"utt{i}.wav", u, 16000)
            entries.append({"audio": str(d / f"utt{i}.wav"),
                            "hubert": "1 2 3", "duration": len(u) / 16000})
        write_manifest(d / "val.jsonl", entries)
        _ida_files(torch, setup, d)
        fused_resblock_step.launches = 0
        t0 = time.perf_counter()
        rtfs = inpaint_da.main([
            "--config", str(IDA_CONFIG), "--manifest", str(d / "val.jsonl"),
            "--codegen-checkpoint", str(d / "g_00400000"),
            "--hubert", str(d / "hubert-base"), "--layer", str(IDA_TAP),
            "--kmeans", str(d / "km.npy"), "--mask-ms",
            *map(str, IDA_CLI_MASKS_MS), "--out", str(d / "out"),
            "--device", "cuda"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = fused_resblock_step.launches
        want = sorted(f"utt{i}_{s}.wav" for i in range(2) for s in (
            "gt", "gen", *(f"{k}_{ms}" for ms in IDA_CLI_MASKS_MS
                           for k in ("masked", "inpainted"))))
        written = sorted(p.name for p in (d / "out").iterdir())
        # the same wav and weights through the inpainter directly
        wav, _ = load_wav(d / "utt0.wav", target_sr=16000)
        emb = mel_stats_embedder(cfg.embedding_dim, device="cuda")(wav,
                                                                   16000)
        direct = _ida_inpainter(torch, setup, torch.float32)(
            wav, 3200, emb=emb)["audio_inpainted"]
        save_wav(d / "direct.wav", direct.cpu().numpy(), 16000)
        steps = _int16_steps(d / "out" / "utt0_inpainted_200.wav",
                             d / "direct.wav")
    n_calls = 2 * len(IDA_CLI_MASKS_MS)
    ok = (written == want and steps <= 1 and launches == 180 * n_calls
          and len(rtfs) == n_calls)
    row = {"phase": "ida_cli", "utterances": 2,
           "masks_ms": list(IDA_CLI_MASKS_MS), "written": len(written),
           "expected_written": len(want),
           "inpainted_200_vs_direct_int16_steps": steps,
           "launches": launches, "expected_launches": 180 * n_calls,
           "launches_per_utterance_per_mask": launches / n_calls,
           "median_rtf": float(np.median(rtfs)), "rtfs": rtfs,
           "seconds": seconds, "ok": ok}
    emit(row)
    if not ok:
        raise AssertionError("inpaint_da CLI check failed")
    return row


# ------------------------------------------------------ the evaluation paths

SWEEP_MASKS_MS = (100, 200, 400)   # a reduced cut of the 20-400 ms protocol
SWEEP_POSITIONS = 8
SWEEP_SEED = 1234                  # build_mask_sweep's default seed
SWEEP_LAUNCHES = 2 * 72 * len(SWEEP_MASKS_MS)   # batch + batch_expected
# the CPU tests' metric tolerances (tests/test_torch_evaluate.py): the unit
# columns equal, these within their absolute gaps
UNIT_METRICS = ("unit_acc", "uer", "uer_mask", "uer_mask_edits")
METRIC_ATOL = {**dict.fromkeys(("stoi", "estoi", "lsd_d2", "lsd_rmse",
                                "mel_l1_mask", "stoi_vs_exp",
                                "estoi_vs_exp"), 1e-3),
               **dict.fromkeys(("pesq", "si_sdr", "pesq_vs_exp",
                                "si_sdr_vs_exp"), 1e-2)}


def _metric_gaps(got: dict, want: dict) -> tuple[bool, dict]:
    """(keys equal, the unit columns equal and every other metric within
    METRIC_ATOL; the gap per metric)."""
    gaps = {k: abs(got[k] - want[k]) for k in want if k in got}
    ok = set(got) == set(want) and all(
        gap == 0.0 if k in UNIT_METRICS else gap <= METRIC_ATOL.get(k, 0.0)
        for k, gap in gaps.items())
    return ok, gaps


@contextlib.contextmanager
def _recording(evaluate):
    """Record, while `infer.evaluate` runs: each device batch's host arrays
    and wall seconds (a device batch ends with its results on the host, so
    its time holds the card's), and each (wav, mask length) call's wall
    seconds."""
    rec = {"batches": [], "device_s": [], "call_s": []}
    device_batch, call = evaluate._device_batch, evaluate.evaluate_inpainting

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            rec[key].append(time.perf_counter() - t0)
            if key == "device_s":
                rec["batches"].append(out)
            return out
        return wrapper

    evaluate._device_batch = timed(device_batch, "device_s")
    evaluate.evaluate_inpainting = timed(call, "call_s")
    try:
        yield rec
    finally:
        evaluate._device_batch, evaluate.evaluate_inpainting = (device_batch,
                                                                call)


def _oracle_labels(torch, wav22, centroids) -> np.ndarray:
    """The clean utterance's nearest centroids on the full hop-441 mel grid
    (of the peak-normalised wave, as the inpainter's mel), on the CPU."""
    from speech_inpainting_torch.infer.inpaint import peak_normalize
    from speech_inpainting_torch.ops.mel import (HUBERT_ALIGNED_MEL_22K,
                                                 mel_spectrogram)
    from speech_inpainting_torch.quantize.kmeans import assign
    with torch.inference_mode():
        mel = mel_spectrogram(peak_normalize(torch.as_tensor(wav22)),
                              HUBERT_ALIGNED_MEL_22K)
        return assign(mel.T, torch.as_tensor(centroids)).numpy()


def _sweep_gaps(a: dict, b: dict, ra: dict, rb: dict, atol) -> dict:
    """Two runs of one sweep: their device arrays (waveforms within `atol`,
    predicted labels equal) and every metric of every (wav, mask length)
    and of the mean table (`_metric_gaps`)."""
    wave = max(float(np.abs(x[k] - y[k]).max())
               for x, y in zip(ra["batches"], rb["batches"])
               for k in ("inpainted", "expected"))
    labels = all(np.array_equal(x["pred_labels"], y["pred_labels"])
                 for x, y in zip(ra["batches"], rb["batches"]))
    ok, worst = wave <= atol and labels, {}
    for name in a:
        for ms in a[name]:
            good, gaps = _metric_gaps(a[name][ms], b[name][ms])
            ok = ok and good
            for k, g in gaps.items():
                worst[k] = max(worst.get(k, 0.0), g)
    return {"waveform_max_abs": wave, "tolerance": atol,
            "pred_labels_equal": labels, "metric_max_gaps": worst, "ok": ok}


def phase_evaluate_sweep(torch, main_setup, covered, d: Path) -> dict:
    """The mask-sweep harness (`infer/evaluate.py:evaluate_sweep`) over the
    I_ea inpainter at full width: `_ea_setup`'s HuBERT-base + head and
    100×80 codebook, with V1 drawn to carry the mel (`generator_tree(carry=
    True)`: under HiFi-GAN's N(0, 0.01) init the waveform barely moves with
    the mel, and SI-SDR between the inpainted and the oracle renderings
    then reads rounding noise), one synthetic 4 s utterance, masks of
    100/200/400 ms × 8 positions (seed 1234), oracle labels (the clean
    utterance's nearest centroids on the full mel grid) and the
    mel-centroid `UnitScorer` of `score._mel_unit_scorer`. Gates: K1's
    launches (72 per `batch` and per `batch_expected`), the kernel path
    against the plain path and card against CPU on `_short_inputs` (one
    length × 2 positions): waveforms within MAIN_ATOL / CPU_ATOL, labels
    equal, every metric within the CPU tests' tolerances; K1 against its
    plain version at the B = 8 tiles no earlier check reached."""
    from speech_inpainting_torch.cli.score import _mel_unit_scorer
    from speech_inpainting_torch.infer import evaluate
    from speech_inpainting_torch.infer.inpaint import InformedInpainter
    from speech_inpainting_torch.ops.resblock import fused_resblock1
    from speech_inpainting_torch.testing import (generator_tree,
                                                 synthetic_batch)
    t_phase = time.perf_counter()
    cfg, hp, _, centroids = main_setup
    gp = generator_tree(cfg.hifigan, np.random.default_rng(SEED + 90),
                        carry=True)
    w22, w16, _, _ = synthetic_batch(np.random.default_rng(SEED + 91), 1,
                                     4.0)
    wavs22, wavs16 = {"utt": w22[0]}, {"utt": w16[0]}
    sweep = evaluate.build_mask_sweep({"utt": w16.shape[1]}, SWEEP_MASKS_MS,
                                      n_positions=SWEEP_POSITIONS,
                                      seed=SWEEP_SEED)
    labels = {"utt": _oracle_labels(torch, w22[0], centroids)}
    np.save(d / "km.npy", centroids)
    units = _mel_unit_scorer(str(d / "km.npy"), "cuda")
    inp = InformedInpainter(cfg, hp, gp, centroids)

    def run(inp, units, wavs=(wavs22, wavs16), sweep=sweep, labels=labels):
        with _recording(evaluate) as rec:
            t0 = time.perf_counter()
            res = evaluate.evaluate_sweep(inp, *wavs, sweep, labels=labels,
                                          unit_scorer=units)
            torch.cuda.synchronize()
            rec["seconds"] = time.perf_counter() - t0
        return res, rec

    # one warm batch at the sweep's shapes (cuDNN's and cuBLAS's first
    # calls at them), then the counted run
    evaluate._device_batch(inp, w22[0], w16[0], np.zeros(8, np.int64),
                           np.full(8, 5, np.int64), None)
    fused_resblock1.launches = 0
    res, rec = run(inp, units)
    launches = fused_resblock1.launches
    inp.generator.use_kernel = False
    plain, plain_rec = run(inp, units)
    inp.generator.use_kernel = True
    vs_plain = _sweep_gaps(res, plain, rec, plain_rec, MAIN_ATOL)

    # card against CPU on the short input, one length × 2 positions
    s22, s16, _, _ = _short_inputs()
    short = {"short": s22[0]}, {"short": s16[0]}
    s_sweep = evaluate.build_mask_sweep({"short": s16.shape[1]}, (100,),
                                        n_positions=2, seed=SWEEP_SEED)
    s_labels = {"short": _oracle_labels(torch, s22[0], centroids)}
    cpu = InformedInpainter(cfg, hp, gp, centroids, device="cpu")
    card_s, card_rec = run(inp, units, short, s_sweep, s_labels)
    cpu_s, cpu_rec = run(cpu, _mel_unit_scorer(str(d / "km.npy"), "cpu"),
                         short, s_sweep, s_labels)
    vs_cpu = _sweep_gaps(card_s, cpu_s, card_rec, cpu_rec, CPU_ATOL)

    checks = _k1_checks(torch, _uncovered_shapes(
        torch, covered, (SWEEP_POSITIONS,), _v1_stage_T(344)),
        "evaluate_kernel_check", SEED + 92)
    n_pos = sum(len(p) for p in sweep["utt"].values())
    host_s = [c - b for c, b in zip(rec["call_s"], rec["device_s"])]
    ok = (launches == SWEEP_LAUNCHES and vs_plain["ok"] and vs_cpu["ok"])
    row = {"phase": "evaluate_sweep", "masks_ms": list(SWEEP_MASKS_MS),
           "positions": SWEEP_POSITIONS, "batch": SWEEP_POSITIONS,
           "launches": launches, "expected_launches": SWEEP_LAUNCHES,
           "kernel_vs_plain": vs_plain, "card_vs_cpu": vs_cpu,
           "kernel_checks": len(checks),
           "card_s_per_batch": rec["device_s"],
           "host_metric_s_per_wav_length": host_s,
           "sweep_seconds": rec["seconds"],
           "positions_per_second": n_pos / rec["seconds"],
           # each position scored against the clean reference and against
           # the oracle, whose labels span the whole mel grid
           "pairs_per_second": 2 * n_pos / rec["seconds"],
           "plain_sweep_seconds": plain_rec["seconds"],
           "phase_seconds": time.perf_counter() - t_phase, "ok": ok}
    emit(row)
    emit({"phase": "evaluate_sweep_mean", "mean": res["mean"]})
    if not ok:
        raise AssertionError("evaluate_sweep check failed")
    return {**row, "kernel_check_rows": checks, "clean": w22[0],
            "estimates_400": rec["batches"][SWEEP_MASKS_MS.index(400)][
                "inpainted"], "positions_400": sweep["utt"][400],
            "kmeans": d / "km.npy"}


def phase_score_cli(torch, ev: dict, d: Path) -> dict:
    """`score.main` on the card on the sweep's 400 ms estimates and the
    clean utterance written as 22.05 kHz wavs, in pair mode and directory
    mode, with `--kmeans` (the codebook as .npy) and `--mask` (the first
    position's span): every value equal to a direct `score_pair` call; the
    unit IDs of every wav equal on the card and on the CPU; `--text` with
    no usable Whisper prints the note and scores no WER/CER."""
    import io
    from speech_inpainting_torch.cli import score
    from speech_inpainting_torch.data.audio import load_wav, save_wav
    from speech_inpainting_torch.metrics.asr import WhisperScorer
    t_phase = time.perf_counter()
    ref_dir, deg_dir = d / "ref", d / "deg"
    ref_dir.mkdir()
    deg_dir.mkdir()
    for i, est in enumerate(ev["estimates_400"]):
        save_wav(ref_dir / f"pos{i}.wav", ev["clean"][:est.shape[-1]], 22050)
        save_wav(deg_dir / f"pos{i}.wav", est, 22050)
    start = ev["positions_400"][0] // 320 * 0.02
    mask = f"{start:.2f}:{start + 0.4:.2f}"
    km = str(ev["kmeans"])
    units = ["--kmeans", km, "--mask", mask, "--device", "cuda"]
    pair = ["--ref", str(ref_dir / "pos0.wav"), "--deg",
            str(deg_dir / "pos0.wav")]
    t0 = time.perf_counter()
    res_pair = score.main(pair + units)
    pair_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_dir = score.main(["--ref-dir", str(ref_dir), "--deg-dir",
                          str(deg_dir), "--json", str(d / "scores.json")]
                         + units)
    dir_s = time.perf_counter() - t0
    card_units = score._mel_unit_scorer(km, "cuda")
    cpu_units = score._mel_unit_scorer(km, "cpu")
    span = tuple(float(v) for v in mask.split(":"))
    equal, units_equal = True, True
    for name in res_dir["files"]:
        ref, _ = load_wav(ref_dir / f"{name}.wav")
        deg, _ = load_wav(deg_dir / f"{name}.wav")
        direct = score.score_pair(ref, deg, 22050, unit_scorer=card_units,
                                  mask_span=span, device="cuda")
        equal = equal and direct == res_dir["files"][name]
        for w in (ref, deg):
            units_equal = units_equal and np.array_equal(
                card_units.units(w, 22050), cpu_units.units(w, 22050))
    equal = equal and res_pair["files"]["pos0"] == res_dir["files"]["pos0"]
    mean_equal = res_dir["mean"] == {
        k: float(np.mean([r[k] for r in res_dir["files"].values()]))
        for k in res_dir["mean"]}
    whisper = WhisperScorer.available()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res_text = score.main(pair + units + ["--text", "a test sentence"])
    note = "note: no local Whisper cache — WER/CER skipped" in out.getvalue()
    no_wer = "wer" not in res_text["files"]["pos0"]
    ok = (equal and mean_equal and units_equal and not whisper and note
          and no_wer and len(res_dir["files"]) == len(ev["estimates_400"]))
    row = {"phase": "score_cli", "pairs": len(res_dir["files"]),
           "mask": mask, "values_equal_direct": equal,
           "mean_equal": mean_equal, "units_card_equal_cpu": units_equal,
           "whisper_available": whisper, "text_note_printed": note,
           "pair_seconds": pair_s, "dir_seconds": dir_s,
           "phase_seconds": time.perf_counter() - t_phase,
           "mean": res_dir["mean"], "ok": ok}
    emit(row)
    if not ok:
        raise AssertionError("score CLI check failed")
    return row


def phase_predict_asr_cli(torch, ida) -> dict:
    """`predict_asr.main` on the card as a user runs it, on `_ida_files`
    (configs/da_hubert100_lut.json's full width, HuBERT-base tapped at
    layer 6): `--donor` (a 4 s donor recording, a speaker wav, a 4 s input
    masked over 1.5-1.7 s) writes every artifact, its `output_tts.wav`
    within 1 int16 step of a direct `UnitResynthTTS` call on the same trees
    (180 K2 launches, two vocoder calls), the kernel path against the plain
    path (atol MAIN_ATOL); `--synth` on that rendering writes files equal
    to a direct `asr_tts_baseline` call."""
    import tempfile
    from speech_inpainting_torch.cli import predict_asr
    from speech_inpainting_torch.data.audio import load_wav, save_wav
    from speech_inpainting_torch.data.code_dataset import mel_stats_embedder
    from speech_inpainting_torch.infer.asr_baseline import (
        ASRBaselineConfig, UnitResynthTTS, asr_tts_baseline)
    from speech_inpainting_torch.ops.resblock import fused_resblock_step
    t_phase = time.perf_counter()
    setup = ida["setup"]
    utts = setup["utts"]
    masked = utts[1].copy()
    masked[24000:27200] = 0.0
    span = (1.5, 1.7)
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        _ida_files(torch, setup, d)
        for name, wav in (("masked", masked), ("donor", utts[0]),
                          ("speaker", utts[2])):
            _write_wav(d / f"{name}.wav", wav, 16000)
        base = ["--input", str(d / "masked.wav"), "--mask",
                f"{span[0]}:{span[1]}", "--device", "cuda"]
        fused_resblock_step.launches = 0
        t0 = time.perf_counter()
        res = predict_asr.main(base + [
            "--donor", str(d / "donor.wav"), "--config", str(IDA_CONFIG),
            "--codegen-checkpoint", str(d / "g_00400000"),
            "--hubert", str(d / "hubert-base"), "--layer", str(IDA_TAP),
            "--kmeans", str(d / "km.npy"), "--speaker-wav",
            str(d / "speaker.wav"), "--out", str(d / "donor_out")])
        torch.cuda.synchronize()
        donor_s = time.perf_counter() - t0
        launches = fused_resblock_step.launches
        written = sorted(p.name for p in (d / "donor_out").iterdir())
        want = sorted(["orig.wav", "speaker_wav.wav", "output_tts.wav",
                       "mask_synth_stretched.wav", "inpainted.wav",
                       "inpainted_with_silence.wav", "transcript.txt"])
        # the same files' arrays through the port directly
        donor, _ = load_wav(d / "donor.wav", target_sr=16000)
        speaker, _ = load_wav(d / "speaker.wav", target_sr=16000)
        inp = _ida_inpainter(torch, setup, torch.float32)
        tts = UnitResynthTTS(inp, embedder=mel_stats_embedder(
            setup["cfg"].embedding_dim, device="cuda"))
        direct = tts(donor, speaker)
        save_wav(d / "direct_tts.wav", direct, 16000)
        steps = _int16_steps(d / "donor_out" / "output_tts.wav",
                             d / "direct_tts.wav")
        inp.codegen.generator.use_kernel = False
        plain = tts(donor, speaker)
        inp.codegen.generator.use_kernel = True
        diff = float(np.abs(direct - plain).max())
        # --synth on that rendering, against a direct call
        t0 = time.perf_counter()
        predict_asr.main(base + [
            "--synth", str(d / "donor_out" / "output_tts.wav"),
            "--transcript", "a test sentence", "--out", str(d / "synth_out")])
        synth_s = time.perf_counter() - t0
        y_synth, _ = load_wav(d / "donor_out" / "output_tts.wav",
                              target_sr=16000)
        ref = asr_tts_baseline(load_wav(d / "masked.wav", target_sr=16000)[0],
                               span, y_synth=y_synth,
                               transcript="a test sentence",
                               cfg=ASRBaselineConfig())
        synth_steps = 0
        for name, key in (("inpainted.wav", "inpainted"),
                          ("inpainted_with_silence.wav",
                           "inpainted_with_silence"),
                          ("mask_synth_stretched.wav", "patch")):
            save_wav(d / "direct.wav", ref[key], 16000)
            synth_steps = max(synth_steps, _int16_steps(
                d / "synth_out" / name, d / "direct.wav"))
    ok = (written == want and launches == 180 and steps <= 1
          and diff <= MAIN_ATOL and synth_steps == 0
          and float(np.abs(direct).max()) > 1e-3)
    row = {"phase": "predict_asr_cli", "written": len(written),
           "expected_written": len(want), "launches": launches,
           "expected_launches": 180, "output_tts_vs_direct_int16_steps":
           steps, "kernel_vs_plain_max_abs": diff, "tolerance": MAIN_ATOL,
           "synth_vs_direct_int16_steps": synth_steps,
           "patch_seconds": len(res["patch"]) / 16000,
           "target_span_s": [float(v) for v in res["target_span_s"]],
           "donor_seconds": donor_s, "synth_seconds": synth_s,
           "phase_seconds": time.perf_counter() - t_phase, "ok": ok}
    emit(row)
    if not ok:
        raise AssertionError("predict_asr CLI check failed")
    return row


def _vocode_dir(torch, d: Path, gcfg, tree, rng,
                codebook: bool) -> np.ndarray:
    """A `vocode` user's files: a `g_*` of `tree`, two synthetic 4 s
    22.05 kHz wavs, their VOCODER_MEL_22K mels as .npy (computed on the
    CPU from the peak-normalised wavs, as the CLI's wav2wav does) and,
    with `codebook`, a 100×80 codebook of frames of those mels moved off
    them by noise. Returns the first wav's mel (80, frames)."""
    from speech_inpainting_torch.data.audio import load_wav, peak_normalize
    from speech_inpainting_torch.ops.mel import (VOCODER_MEL_22K,
                                                 mel_spectrogram)
    from speech_inpainting_torch.testing import (generator_state_dict,
                                                 synthetic_batch)
    torch.save({"generator": generator_state_dict(tree, gcfg)},
               d / "g_02500000")
    (d / "wavs").mkdir()
    (d / "mels").mkdir()
    mels = []
    for i, w in enumerate(synthetic_batch(rng, 2, 4.0)[0]):
        _write_wav(d / "wavs" / f"utt{i}.wav", w, 22050)
        wav, _ = load_wav(d / "wavs" / f"utt{i}.wav", target_sr=22050)
        mel = pinned(mel_spectrogram, torch.as_tensor(
            peak_normalize(wav, 0.95)), VOCODER_MEL_22K).numpy()
        np.save(d / "mels" / f"utt{i}.npy", mel)
        mels.append(mel)
    if codebook:
        frames = np.concatenate([m.T for m in mels])
        np.save(d / "km.npy", (frames[rng.choice(len(frames), 100,
                                                 replace=False)]
                               + 0.05 * rng.standard_normal((100, 80))
                               ).astype(np.float32))
    return mels[0]


def _vocode_runs(torch, d: Path, config: Path, modes) -> dict:
    """The `vocode` CLI on the card and on the CPU, each mode: K2's
    launches and the wall seconds of the card's runs, and the largest gap
    in int16 steps between the card's and the CPU's files."""
    from speech_inpainting_torch.cli import vocode
    from speech_inpainting_torch.ops.resblock import fused_resblock_step
    extra = {"wav2wav": ["--input-dir", str(d / "wavs")],
             "quantized": ["--input-dir", str(d / "wavs"), "--quantize-mel",
                           str(d / "km.npy"), "--quantize-span", "50:200"],
             "mel2wav": ["--input-dir", str(d / "mels")]}
    out = {"launches": {}, "seconds": {}, "card_vs_cpu_int16_steps": {}}
    for mode in modes:
        cmd = "mel2wav" if mode == "mel2wav" else "wav2wav"
        for device in ("cuda", "cpu"):
            fused_resblock_step.launches = 0
            t0 = time.perf_counter()
            vocode.main([cmd, *extra[mode], "--checkpoint",
                         str(d / "g_02500000"), "--config", str(config),
                         "--out", str(d / f"{mode}_{device}"), "--device",
                         device])
            if device == "cuda":
                torch.cuda.synchronize()
                out["seconds"][mode] = time.perf_counter() - t0
                out["launches"][mode] = fused_resblock_step.launches
        files = sorted(p.name for p in (d / f"{mode}_cuda").iterdir())
        if files != sorted(p.name for p in (d / f"{mode}_cpu").iterdir()) \
                or len(files) != 2:
            raise AssertionError(f"vocode {mode}: files {files}")
        out["card_vs_cpu_int16_steps"][mode] = max(
            _int16_steps(d / f"{mode}_cuda" / f, d / f"{mode}_cpu" / f)
            for f in files)
        out.setdefault("files", {})[mode] = files
    return out


def _generator_gaps(torch, g_file, gcfg, mel) -> dict:
    """The `g_*` file's Generator (K2) on one mel: card against CPU, and
    the card's kernel path against its plain path, f32 waveforms."""
    from speech_inpainting_torch.convert.hifigan_torch import (
        load_generator_checkpoint)
    from speech_inpainting_torch.device import full_f32
    from speech_inpainting_torch.models.hifigan import Generator
    card = load_generator_checkpoint(g_file, gcfg, device="cuda",
                                     cls=Generator)
    cpu = load_generator_checkpoint(g_file, gcfg, device="cpu",
                                    cls=Generator)
    x = torch.as_tensor(mel)[None]
    with torch.inference_mode(), full_f32():
        a = card(x.cuda()).cpu()
        b = cpu(x)
        card.use_kernel = False
        plain = card(x.cuda()).cpu()
    return {"card_vs_cpu_max_abs": (a - b).abs().max().item(),
            "kernel_vs_plain_max_abs": (a - plain).abs().max().item(),
            "output_std": b.std().item(), "samples": b.shape[-1]}


def _forward_ms(torch, generators: dict, mel, order) -> dict:
    """ms per forward of each generator on the card at B = 1, in the turns
    `order` gives (each name twice), averaged per name."""
    from speech_inpainting_torch.device import full_f32
    times = {}
    with torch.inference_mode(), full_f32():
        x = torch.as_tensor(mel, device="cuda")[None]
        for name in order:
            times.setdefault(name, []).append(
                cuda_ms(lambda: generators[name](x), 5))
    return {name: sum(v) / len(v) for name, v in times.items()}


def phase_vocode(torch) -> dict:
    """The `vocode` CLI as a user runs it, V1 at full width
    (configs/hifigan_v1.json, weights that carry the signal), B = 1:
    `wav2wav` on two 4 s 22.05 kHz wavs, `mel2wav` on their mels and
    `--quantize-mel` with a 100×80 codebook, each on the card and on the
    CPU (files within 4 int16 steps: atol 1e-4 plus a step of rounding); 72
    K2 launches per forward; the generator card vs CPU and kernel path vs
    plain path (f32 waveform atol 1e-4); K2 against its plain version at
    every (C, K, d) step of these lengths; ms per forward, f32 and bf16."""
    import tempfile
    from speech_inpainting_torch.convert.hifigan_torch import (
        load_generator_checkpoint)
    from speech_inpainting_torch.models.hifigan import (Generator,
                                                        HiFiGANConfig)
    from speech_inpainting_torch.testing import generator_tree
    config = CONFIGS / "hifigan_v1.json"
    gcfg = HiFiGANConfig.from_dict(json.loads(config.read_text()))
    rng = np.random.default_rng(SEED + 90)
    tree = generator_tree(gcfg, rng, carry=True)
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        mel = _vocode_dir(torch, d, gcfg, tree, rng, codebook=True)
        runs = _vocode_runs(torch, d, config,
                            ("wav2wav", "quantized", "mel2wav"))
        gaps = _generator_gaps(torch, d / "g_02500000", gcfg, mel)
        frames = mel.shape[-1]
        gens = {name: load_generator_checkpoint(
            d / "g_02500000", dataclasses.replace(gcfg, dtype=dt),
            device="cuda", cls=Generator)
            for name, dt in (("f32", torch.float32),
                             ("bf16", torch.bfloat16))}
    ms = _forward_ms(torch, gens, mel, ("f32", "bf16", "bf16",
                                                 "f32"))
    n = 2 * len(gcfg.upsample_rates) * sum(
        len(r) for r in gcfg.resblock_dilation_sizes)      # per forward
    stage_T, t = {}, frames
    for i, u in enumerate(gcfg.upsample_rates):
        t *= u
        stage_T[gcfg.upsample_initial_channel // 2 ** (i + 1)] = t
    path = {"T": stage_T, "kernel_sizes": gcfg.resblock_kernel_sizes,
            "dilations": gcfg.resblock_dilation_sizes}
    ok = (all(v == 2 * n for v in runs["launches"].values())
          and all(v <= 4 for v in runs["card_vs_cpu_int16_steps"].values())
          and gaps["card_vs_cpu_max_abs"] <= CPU_ATOL
          and gaps["kernel_vs_plain_max_abs"] <= MAIN_ATOL
          and gaps["output_std"] > 0.01)
    row = {"phase": "vocode", "config": "hifigan_v1.json", "B": 1,
           "frames": frames, "launches": runs["launches"],
           "expected_launches_per_mode": 2 * n,
           "launches_per_forward": n, "cli_seconds": runs["seconds"],
           "card_vs_cpu_int16_steps": runs["card_vs_cpu_int16_steps"],
           **gaps, "tolerance": CPU_ATOL, "f32_ms_per_forward": ms["f32"],
           "bf16_ms_per_forward": ms["bf16"], "ok": ok}
    emit(row)
    if not ok:
        raise AssertionError("vocode check failed")
    errs = phase_ida_kernel_check(torch, path, name="vocode_kernel_check")
    return {"launches_per_forward": n, "row": row, "kernel_check": errs,
            "path": path}


def phase_v3(torch) -> dict:
    """`vocode wav2wav` from a V3 `g_*` (configs/hifigan_v3.json at full
    width, ResBlock2, whose convs are torch's: no K2 launch), on the card
    and the CPU (files within 4 int16 steps); the generator card vs CPU
    (f32 atol 1e-4); ms per forward beside V1's, in turns, f32 and
    bf16."""
    import tempfile
    from speech_inpainting_torch.convert.hifigan_torch import (
        load_generator_checkpoint)
    from speech_inpainting_torch.models.hifigan import (Generator,
                                                        HiFiGANConfig)
    from speech_inpainting_torch.testing import (generator_state_dict,
                                                 generator_tree)
    config = CONFIGS / "hifigan_v3.json"
    gcfg = HiFiGANConfig.from_dict(json.loads(config.read_text()))
    rng = np.random.default_rng(SEED + 100)
    tree = generator_tree(gcfg, rng, carry=True)
    v1cfg = HiFiGANConfig()
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        mel = _vocode_dir(torch, d, gcfg, tree, rng, codebook=False)
        runs = _vocode_runs(torch, d, config, ("wav2wav",))
        gaps = _generator_gaps(torch, d / "g_02500000", gcfg, mel)
        torch.save({"generator": generator_state_dict(
            generator_tree(v1cfg, rng, carry=True), v1cfg)}, d / "g_v1")
        gens = {}
        for dtype in (torch.float32, torch.bfloat16):
            name = "f32" if dtype == torch.float32 else "bf16"
            for arch, c, f in (("v3", gcfg, d / "g_02500000"),
                               ("v1", v1cfg, d / "g_v1")):
                gens[f"{arch}_{name}"] = load_generator_checkpoint(
                    f, dataclasses.replace(c, dtype=dtype), device="cuda",
                    cls=Generator)
    ms = {}
    for name in ("f32", "bf16"):
        ms.update(_forward_ms(torch, gens, mel,
                              (f"v1_{name}", f"v3_{name}", f"v3_{name}",
                               f"v1_{name}")))
    ok = (runs["launches"]["wav2wav"] == 0
          and runs["card_vs_cpu_int16_steps"]["wav2wav"] <= 4
          and gaps["card_vs_cpu_max_abs"] <= CPU_ATOL
          and gaps["kernel_vs_plain_max_abs"] == 0.0
          and gaps["output_std"] > 0.01)
    row = {"phase": "v3", "config": "hifigan_v3.json", "B": 1,
           "k2_launches": runs["launches"]["wav2wav"],
           "cli_seconds": runs["seconds"]["wav2wav"],
           "card_vs_cpu_int16_steps": runs["card_vs_cpu_int16_steps"],
           **gaps, "tolerance": CPU_ATOL,
           "ms_per_forward": ms, "order": "v1, v3, v3, v1 per type",
           "ok": ok}
    emit(row)
    if not ok:
        raise AssertionError("V3 vocode check failed")
    return row


def phase_f0vq(torch) -> dict:
    """`FoVQVAE.__call__` at full width (configs/f0_vqvae.json: 1 → 32
    channels, 4 strided stages, 20 × 128 codebook) from a reference-layout
    f0-VQ-VAE `g_*`, on the normalised f0 track of a synthetic 4 s
    utterance (computed once, on the CPU): the card against the CPU,
    reconstruction atol 1e-4, units equal; ms per call."""
    import tempfile
    from speech_inpainting_torch.convert.from_jax import fo_vqvae_from_jax
    from speech_inpainting_torch.convert.ida_torch import (
        load_fo_vqvae_checkpoint)
    from speech_inpainting_torch.device import full_f32
    from speech_inpainting_torch.models.codegen import FoVQVAEConfig
    from speech_inpainting_torch.ops.f0 import extract_f0, normalize_nonzero
    from speech_inpainting_torch.testing import (fo_vqvae_state_dict,
                                                 fo_vqvae_tree,
                                                 synthetic_utterance)
    cfg = FoVQVAEConfig.from_dict(json.loads(
        (CONFIGS / "f0_vqvae.json").read_text()))
    rng = np.random.default_rng(SEED + 110)
    params, vq = fo_vqvae_tree(cfg, rng)
    f0 = pinned(extract_f0, torch.as_tensor(synthetic_utterance(rng, 4.0)))
    f0 = normalize_nonzero(f0, f0.mean(), f0.std(correction=0))
    stride = cfg.encoder.total_stride
    x = f0[:len(f0) // stride * stride][None, None]
    # the codebook: encoder outputs of this input, spread (training would
    # have put it there; N(0, 1) rows send nearly every frame to one code)
    with torch.inference_mode():
        h = fo_vqvae_from_jax(cfg, params, vq, device="cpu").encoder(x)[0]
    frames = h[0].t().numpy()
    vq["vq"]["level_0"]["k"] = _spread_rows(frames, cfg.l_bins)
    margin = _unit_margin(torch, h[0].t(), vq["vq"]["level_0"]["k"])
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({"generator": fo_vqvae_state_dict(params, vq, cfg)},
                   Path(tmp) / "g_00400000")
        card, cpu = (load_fo_vqvae_checkpoint(Path(tmp) / "g_00400000", cfg,
                                              device=dev)
                     for dev in ("cuda", "cpu"))
    with torch.inference_mode(), full_f32():
        a, ca, ma = card(x.cuda())
        b, cb, mb = cpu(x)
        ua, ub = card.encode_units(x.cuda()).cpu(), cpu.encode_units(x)
        ms = cuda_ms(lambda: card(x.cuda()), 10)
    diff = (a.cpu() - b).abs().max().item()
    units_equal = bool(torch.equal(ua, ub))
    ok = (tuple(a.shape) == tuple(x.shape) and bool(torch.isfinite(a).all())
          and diff <= CPU_ATOL and units_equal
          and ub.shape[-1] == x.shape[-1] // stride)
    row = {"phase": "f0vq", "config": "f0_vqvae.json",
           "f0_frames": x.shape[-1], "units": ub.shape[-1],
           "distinct_units": int(ub.unique().numel()),
           "unit_margin_min": margin,
           "reconstruction_card_vs_cpu_max_abs": diff,
           "tolerance": CPU_ATOL, "units_equal": units_equal,
           "commit_card": ca[0].item(), "commit_cpu": cb[0].item(),
           "ms_per_call": ms, "ok": ok}
    emit(row)
    if not ok:
        raise AssertionError("f0-VQ-VAE check failed")
    return row


def phase_content_vq(torch) -> dict:
    """`vocode codes` and the CodeGenerator's content-VQ forward (from
    integer units and from a waveform) from a reference-layout `g_*`, at
    CONTENT_VQ's geometry: the card against the CPU, units equal (the
    codes files equal), waveforms atol 1e-4; K2's launches per forward."""
    import tempfile
    from speech_inpainting_torch.cli import vocode
    from speech_inpainting_torch.convert.from_jax import codegen_from_jax
    from speech_inpainting_torch.convert.ida_torch import (
        load_code_generator_checkpoint)
    from speech_inpainting_torch.device import full_f32
    from speech_inpainting_torch.models.codegen import CodeGeneratorConfig
    from speech_inpainting_torch.ops.resblock import fused_resblock_step
    from speech_inpainting_torch.testing import (code_generator_state_dict,
                                                 codegen_tree,
                                                 synthetic_utterance)
    cfg = CodeGeneratorConfig.from_dict(CONTENT_VQ)
    rng = np.random.default_rng(SEED + 120)
    params, vq = codegen_tree(cfg, rng)
    wavs = [0.5 * synthetic_utterance(rng, 1.0) for _ in range(2)]
    # the codebook: content-encoder outputs of the first wav, spread (N(0,
    # 1) rows send nearly every frame to one code)
    with torch.inference_mode():
        h = codegen_from_jax(cfg, params, vq, device="cpu").code_encoder(
            torch.as_tensor(np.stack(wavs))[:, None])[0]
    vq["code_vq"]["level_0"]["k"] = _spread_rows(h[0].t().numpy(),
                                                 cfg.code_vq_bins)
    margin = _unit_margin(torch, h.transpose(1, 2).reshape(-1, h.shape[1]),
                          vq["code_vq"]["level_0"]["k"])
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        (d / "cfg.json").write_text(json.dumps(CONTENT_VQ))
        torch.save({"generator": code_generator_state_dict(params, vq, cfg)},
                   d / "g_00100000")
        for i, w in enumerate(wavs):
            _write_wav(d / f"utt{i}.wav", w, 16000)
        (d / "list.txt").write_text("".join(
            f"{d / f'utt{i}.wav'}\n" for i in range(2)))
        codes = {}
        for dev in ("cuda", "cpu"):
            vocode.main(["codes", "--config", str(d / "cfg.json"),
                         "--checkpoint", str(d / "g_00100000"), "--manifest",
                         str(d / "list.txt"), "--out",
                         str(d / f"codes_{dev}.txt"), "--device", dev])
            codes[dev] = (d / f"codes_{dev}.txt").read_text()
        card, cpu = (load_code_generator_checkpoint(d / "g_00100000", cfg,
                                                    device=dev)
                     for dev in ("cuda", "cpu"))
    x = torch.as_tensor(wavs[0])[None, None]
    with torch.inference_mode(), full_f32():
        fused_resblock_step.launches = 0
        wa, commit_a, _ = card(x.cuda())
        torch.cuda.synchronize()
        launches = fused_resblock_step.launches
        wb, commit_b, _ = cpu(x)
        ua, ub = card.encode_codes(x.cuda()).cpu(), cpu.encode_codes(x)
        ia, ib = card(ub.cuda())[0].cpu(), cpu(ub)[0]
    wave_diff = (wa.cpu() - wb).abs().max().item()
    unit_diff = (ia - ib).abs().max().item()
    units_equal = bool(torch.equal(ua, ub)) and codes["cuda"] == codes["cpu"]
    n = 2 * len(cfg.hifigan.upsample_rates) * sum(
        len(r) for r in cfg.hifigan.resblock_dilation_sizes)
    ok = (units_equal and wave_diff <= CPU_ATOL and unit_diff <= CPU_ATOL
          and launches == n and len(codes["cuda"].splitlines()) == 2
          and wb.std().item() > 0.01)
    row = {"phase": "content_vq", "geometry": "tests/test_codegen.py:144-160,"
           " generator 64 wide", "units": ub.shape[-1],
           "distinct_units": int(ub.unique().numel()),
           "unit_margin_min": margin, "units_equal": units_equal,
           "waveform_card_vs_cpu_max_abs": wave_diff,
           "from_units_card_vs_cpu_max_abs": unit_diff,
           "commit_card": commit_a.item(), "commit_cpu": commit_b.item(),
           "tolerance": CPU_ATOL, "launches": launches,
           "expected_launches": n, "ok": ok}
    emit(row)
    if not ok:
        raise AssertionError("content-VQ check failed")
    return {"launches": launches, "row": row}


def phase_kmeans_fit(torch) -> dict:
    """`fit_kmeans` at the I_da codebook's shape: k = 100 over 200 000 ×
    768 float32 rows (0.61 GB, 100 clusters drawn on the card), 50 Lloyd
    iterations, n_init 3: seconds and inertia. Then on the first 20 000
    rows, from one shared start (one row of each cluster, so no cluster
    dies and no random restart is drawn) and 10 iterations, the card's
    `_lloyd` against the CPU's: inertia rel 1e-5, at most 0.1% of labels
    different."""
    from speech_inpainting_torch.device import full_f32
    from speech_inpainting_torch.quantize.kmeans import (_lloyd, assign,
                                                         fit_kmeans)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 130)
    centers = torch.randn(KMEANS_K, KMEANS_DIM, generator=gen, device="cuda")
    labels = torch.arange(KMEANS_ROWS, device="cuda") % KMEANS_K
    x = centers[labels] + 0.5 * torch.randn(KMEANS_ROWS, KMEANS_DIM,
                                            generator=gen, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    C, inertia = fit_kmeans(x, KMEANS_K, iters=50, n_init=3, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    recovered = int(assign(centers, C).unique().numel())
    sub, chunk = x[:20000], 5000
    init = sub[:KMEANS_K]
    with full_f32():
        Ca, ia = _lloyd(gen, sub, init, 10, chunk)
        Cb, ib = _lloyd(torch.Generator(), sub.cpu(), init.cpu(), 10, chunk)
        la, lb = assign(sub, Ca).cpu(), assign(sub.cpu(), Cb)
    rel = abs(float(ia) - float(ib)) / float(ib)
    differ = (la != lb).float().mean().item()
    ok = (tuple(C.shape) == (KMEANS_K, KMEANS_DIM)
          and bool(torch.isfinite(C).all()) and np.isfinite(inertia)
          and rel <= 1e-5 and differ <= 1e-3)
    row = {"phase": "kmeans_fit", "rows": KMEANS_ROWS, "dim": KMEANS_DIM,
           "k": KMEANS_K, "iters": 50, "n_init": 3, "seconds": seconds,
           "inertia": inertia, "noise_floor_inertia": 0.25 * KMEANS_DIM,
           "clusters_recovered": recovered,
           "lloyd_card_vs_cpu_inertia_rel": rel,
           "lloyd_card_vs_cpu_labels_differ": differ,
           "lloyd_card_vs_cpu_centroids_max_abs":
               (Ca.cpu() - Cb).abs().max().item(), "ok": ok}
    emit(row)
    if not ok:
        raise AssertionError("k-means fitting check failed")
    return row


# ------------------------------------------------ I_ea training (train_ea)

EA_MASK = 20         # frames, EAConfig's and the CLI's default
EA_SAMPLES = 80003   # the CLI's max_length at 5 s (16 000·5 + 3)
NOISY = ".attention.k_proj.bias"   # gradient zero in exact arithmetic


def _ea_batch(rng, B, samples, K, lengths=None):
    """A training batch as EADataset makes it: `synthetic_utterance` rows
    (each `lengths[b]` long, zero past it), their attention mask, a mask
    position inside each row, and one random codeword over each row's
    masked frames (a sustained sound, which a fixed batch can fit)."""
    from speech_inpainting_torch.testing import synthetic_utterance
    lengths = np.full(B, samples) if lengths is None else np.asarray(lengths)
    wav = np.zeros((B, samples), np.float32)
    for b, n in enumerate(lengths):
        wav[b, :n] = synthetic_utterance(rng, n / 16000)[:n]
    attn = (np.arange(samples)[None] < lengths[:, None]).astype(np.int32)
    max_pos = (np.minimum(lengths, samples) - 80) // 320 - EA_MASK
    return {"wav": wav, "attn_mask": attn,
            "mask_pos": rng.integers(0, max_pos).astype(np.int32),
            "labels": np.repeat(rng.integers(0, K, (B, 1)), EA_MASK,
                                axis=1).astype(np.int32)}


def _trained_like(tree: dict, rng) -> dict:
    """`tree` (testing.py's init: conv biases zero, norms one and zero)
    with every conv bias and norm bias drawn from N(0, 1) and every norm
    scale from 1 + N(0, 0.1), as trained weights have them. With zero
    biases a zeroed (masked) stretch of audio leaves the first conv's
    output exactly zero over its channels there, and HuBERT-large's
    LayerNorm over channels then multiplies the gradient by 1/√eps (316)
    per conv layer: the global norm overflows float32 and the clip (in
    the JAX package too) zeroes the whole update."""
    def walk(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k == "scale":
                out[k] = (1 + 0.1 * rng.standard_normal(v.shape)
                          ).astype(np.float32)
            elif k == "bias" or re.fullmatch(r"conv_\d+_b", k):
                out[k] = rng.standard_normal(v.shape).astype(np.float32)
            else:
                out[k] = v
        return out
    return walk(tree)


def _ea_run(torch, hcfg, tree, centroids, device, batches, to=None,
            **over):
    """Steps of the trainer on `device` from `tree` (its parameters cast
    `to` a type, where given): (state, [metrics])."""
    from speech_inpainting_torch.convert.from_jax import trainable_hubert
    from speech_inpainting_torch.train import ea
    cfg = ea.EAConfig(mask_length=EA_MASK, **over)
    model = trainable_hubert(hcfg, tree, 80, device=device)
    state = ea.create_state(cfg, model if to is None else model.to(to))
    step = ea.make_train_step(cfg, centroids, device)
    ms = []
    for b in batches:
        state, m = step(state, b)
        ms.append({k: float(v) for k, v in m.items()})
    return state, ms


def _named(state, of):
    return {n: of(p).detach().float().cpu()
            for n, p in state.model.named_parameters()}


def _step_gaps(a, b, start, ref=None, lr=1e-4, wd=1e-2, eps=1e-6) -> dict:
    """Two states after one step from the parameters `start`: the
    largest gradient gap over each tensor's largest magnitude (and its
    tensor), the largest parameter excess over rtol 2e-5 + atol 2e-6, and,
    for the k_proj biases (zero gradient: each side's is rounding noise n,
    which AdamW's first step turns into an update of lr·n/(n + eps)), the
    largest update beyond that bound and the largest noise over the
    model's largest gradient. With `ref` (a float64 state after the same
    step), each of a's gradients against ref's beside b's: the largest
    excess of a's gap over max(1e-4, 4 × b's gap), each over the tensor's
    largest magnitude (float32 itself, b, misses float64 by more than 1e-4
    where a tensor's gradient is a small difference of large terms)."""
    ga, gb = _named(a, lambda p: p.grad), _named(b, lambda p: p.grad)
    pa, pb = _named(a, lambda p: p), _named(b, lambda p: p)
    gr = ref and {n: g.double() for n, g in _named(
        ref, lambda p: p.grad).items()}
    top = max(float(g.abs().max()) for g in ga.values())
    out = {"grad_rel": 0.0, "grad_rel_tensor": None, "param_excess": 0.0,
           "param_excess_tensor": None, "noise_update_excess": 0.0,
           "noise_rel": 0.0}
    if ref is not None:
        out.update(grad_vs_f64_excess=-1.0, grad_vs_f64_tensor=None)
    for n in ga:
        if n.endswith(NOISY):
            for g, p in ((ga[n], pa[n]), (gb[n], pb[n])):
                m = float(g.abs().max())
                out["noise_rel"] = max(out["noise_rel"], m / top)
                step = (p - start[n] * (1 - lr * wd)).abs().max()
                out["noise_update_excess"] = max(
                    out["noise_update_excess"],
                    float(step) - lr * m / (m + eps) * 1.001)
            continue
        scale = float(ga[n].abs().max()) or 1.0
        rel = float((ga[n] - gb[n]).abs().max()) / scale
        if rel > out["grad_rel"]:
            out["grad_rel"], out["grad_rel_tensor"] = rel, n
        exc = float(((pa[n] - pb[n]).abs() - 2e-5 * pb[n].abs()).max())
        if exc > out["param_excess"]:
            out["param_excess"], out["param_excess_tensor"] = exc, n
        if ref is not None:
            m = float(gr[n].abs().max()) or 1.0
            gap_a = float((ga[n].double() - gr[n]).abs().max()) / m
            gap_b = float((gb[n].double() - gr[n]).abs().max()) / m
            exc = gap_a - max(1e-4, 4 * gap_b)
            if exc > out["grad_vs_f64_excess"]:
                out.update(grad_vs_f64_excess=exc, grad_vs_f64_tensor=n,
                           grad_vs_f64_card=gap_a, grad_vs_f64_cpu=gap_b)
    return out


def phase_ea_train_parity(torch) -> dict:
    """One I_ea train step at HuBERT-base's full width (768, 12 layers),
    B = 2 × 2 s (one row 1.6 s, padded), f32, from one seeded tree: the
    card against the CPU (loss rel 1e-5, accuracies equal, parameters
    within rtol 2e-5, atol 2e-6, tests/test_train_ea.py's gate) and each
    gradient against the same step in float64 on the CPU (within 1e-4 of
    the tensor's largest magnitude, or within 4 × the CPU's float32 gap
    where that is larger: in the last layers' attention the CPU's float32
    gradient itself misses float64 by more than 1e-4); the k_proj biases,
    whose gradient is rounding noise, held to zero noise (below 1e-6 of the
    largest gradient) and to the update AdamW makes of it. Then on the
    card: grad_accum 2 against 1 (loss rel 1e-5, the same parameter
    gates), a nan batch with skip_nonfinite after a finite one (parameters
    and both moments bit-equal, one skip), and train_encoder off (the
    encoder bit-equal, the head moved)."""
    from speech_inpainting_torch.models.hubert import HubertConfig
    from speech_inpainting_torch.testing import hubert_tree
    rng = np.random.default_rng(SEED + 140)
    hcfg = HubertConfig.base()
    tree = hubert_tree(hcfg, 80, rng)
    centroids = rng.standard_normal((100, 80)).astype(np.float32)
    batch = _ea_batch(rng, 2, 32000, 100, lengths=(32000, 25600))
    t0 = time.perf_counter()
    card, (mc,) = _ea_run(torch, hcfg, tree, centroids, "cuda", [batch])
    cpu, (mp,) = _ea_run(torch, hcfg, tree, centroids, "cpu", [batch])
    f64, _ = _ea_run(torch, HubertConfig.base(dtype=torch.float64), tree,
                     centroids, "cpu", [batch], to=torch.float64)
    start = _named(_ea_run(torch, hcfg, tree, centroids, "cpu", [])[0],
                   lambda p: p)
    gaps = _step_gaps(card, cpu, start, ref=f64)
    del cpu, f64
    accum, (ma,) = _ea_run(torch, hcfg, tree, centroids, "cuda", [batch],
                           grad_accum=2)
    acc_gaps = _step_gaps(card, accum, start)
    del accum
    # a finite step, then a nan batch: nothing moves
    bad = dict(batch, wav=batch["wav"].copy())
    bad["wav"][0, 100] = np.nan
    guarded, _ = _ea_run(torch, hcfg, tree, centroids, "cuda", [batch],
                         skip_nonfinite=5)
    opt = guarded.optimizer
    before = [(p.detach().clone(), opt.state[p]["exp_avg"].clone(),
               opt.state[p]["exp_avg_sq"].clone(), opt.state[p]["step"])
              for p in guarded.model.parameters()]
    from speech_inpainting_torch.train import ea
    step = ea.make_train_step(ea.EAConfig(mask_length=EA_MASK,
                                          skip_nonfinite=5), centroids,
                              "cuda")
    guarded, mb = step(guarded, bad)
    after = [(p, opt.state[p]["exp_avg"], opt.state[p]["exp_avg_sq"],
              opt.state[p]["step"]) for p in guarded.model.parameters()]
    skip_equal = all(torch.equal(x, y) for b4, af in zip(before, after)
                     for x, y in zip(b4[:3], af[:3])) and all(
        b4[3] == af[3] for b4, af in zip(before, after))
    skips = (guarded.guard.notfinite_count, int(mb["nonfinite_skips"]))
    del guarded, before, after
    frozen, _ = _ea_run(torch, hcfg, tree, centroids, "cuda", [batch],
                        train_encoder=False)
    fp = _named(frozen, lambda p: p)
    enc_equal = all(torch.equal(fp[n], start[n]) for n in fp
                    if not n.startswith("head."))
    head_moved = any(not torch.equal(fp[n], start[n]) for n in fp
                     if n.startswith("head."))
    del frozen
    loss_rel = abs(mc["loss"] - mp["loss"]) / abs(mp["loss"])
    accum_rel = abs(ma["loss"] - mc["loss"]) / abs(mc["loss"])
    noise_ok = lambda g: (g["noise_rel"] < 1e-6  # noqa: E731
                          and g["noise_update_excess"] <= 1e-12)
    ok = (loss_rel <= 1e-5 and (mc["acc"], mc["cos_sim_acc"]) ==
          (mp["acc"], mp["cos_sim_acc"]) and gaps["grad_vs_f64_excess"] <= 0
          and gaps["param_excess"] <= 2e-6 and noise_ok(gaps)
          and accum_rel <= 1e-5 and acc_gaps["param_excess"] <= 2e-6
          and noise_ok(acc_gaps) and skip_equal and skips == (1, 1)
          and enc_equal and head_moved)
    row = {"phase": "ea_train_parity", "hubert": "base", "B": 2,
           "samples": 32000, "dtype": "float32", "loss_card": mc["loss"],
           "loss_cpu": mp["loss"], "loss_rel": loss_rel,
           "acc_card_cpu": [mc["acc"], mp["acc"]], "card_vs_cpu": gaps,
           "grad_accum2_loss_rel": accum_rel,
           "grad_accum2_vs_1": acc_gaps, "skip_bit_equal": skip_equal,
           "skips": skips, "frozen_encoder_bit_equal": enc_equal,
           "frozen_head_moved": head_moved,
           "seconds": time.perf_counter() - t0, "ok": ok}
    emit(row)
    if not ok:
        raise AssertionError("I_ea train-step parity check failed")
    return row


def ea_step_bound_ms(hcfg, B, samples, dtype_name) -> dict:
    """The least time of one train step at these shapes: forward and
    backward FLOP (3× the forward's: the conv stack, the positional conv,
    the dense layers, the attention products) over the peak rate of the
    type (f32 runs in full f32, off the tensor cores), plus AdamW's bytes
    (parameter, gradient, two moments read; parameter and two moments
    written, float32) over the memory rate: the update cannot start before
    the last gradient."""
    n, conv = samples, 0.0
    c_in = 1
    for c, k, s in zip(hcfg.conv_dim, hcfg.conv_kernel, hcfg.conv_stride):
        n = (n - k) // s + 1
        conv += 2.0 * n * c * c_in * k
        c_in = c
    T, H, F = n, hcfg.hidden_size, hcfg.intermediate_size
    dense = hcfg.num_hidden_layers * (4 * H * H + 2 * H * F)
    flops = B * (conv + 2.0 * T * (dense + c_in * H)
                 + 2.0 * T * H * (H // hcfg.num_conv_pos_embedding_groups)
                 * hcfg.num_conv_pos_embeddings
                 + hcfg.num_hidden_layers * 4.0 * T * T * H)
    n_params = (dense + sum(c * ci * k for c, ci, k in zip(
        hcfg.conv_dim, (1,) + tuple(hcfg.conv_dim[:-1]), hcfg.conv_kernel))
        + c_in * H + H * H // hcfg.num_conv_pos_embedding_groups
        * hcfg.num_conv_pos_embeddings)
    fwd_bwd_ms = 1e3 * 3 * flops / PEAK_FLOPS[dtype_name]
    adamw_ms = 1e3 * 7 * 4 * n_params / PEAK_BYTES
    return {"forward_tflop": flops / 1e12, "params_millions": n_params / 1e6,
            "fwd_bwd_ms": fwd_bwd_ms, "adamw_ms": adamw_ms,
            "bound_ms": fwd_bwd_ms + adamw_ms}


def _timed_steps(torch, step, state, batch, warmup, iters) -> tuple:
    """(per-step ms by CUDA events, losses): `warmup` untimed steps, then
    `iters` timed ones, each between two events on the compute stream."""
    losses = []
    for _ in range(warmup):
        state, m = step(state, batch)
        losses.append(m["loss"])
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for a, b in events:
        a.record()
        state, m = step(state, batch)
        b.record()
        losses.append(m["loss"])
    torch.cuda.synchronize()
    return ([a.elapsed_time(b) for a, b in events],
            [float(v) for v in losses])


def _profile_step(torch, step, state, batch, top=12) -> dict:
    """One step under torch.profiler (CPU and CUDA activities): the kernels
    that took the most device time, the kernels' total, and the device's
    busy share: the union of the kernels' time spans over the step's time
    between two CUDA events (kernels may overlap, as cuDNN's do on its own
    streams, so their summed time can exceed the step's); "not measured"
    where the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        a.record()
        step(state, batch)
        b.record()
        torch.cuda.synchronize()
    step_ms = a.elapsed_time(b)
    dev = lambda e: getattr(e, "self_device_time_total",  # noqa: E731
                            getattr(e, "self_cuda_time_total", 0)) / 1e3
    # the kernels themselves: an operator's entry sums its kernels again,
    # and a range recorded on the host (Optimizer.step) reappears on the
    # device spanning its kernels
    averages = prof.key_averages()
    host = {e.key for e in averages
            if e.device_type == torch.autograd.DeviceType.CPU}
    events = [e for e in averages
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.key not in host and dev(e) > 0]
    kernel_ms = sum(dev(e) for e in events)
    if not events:
        return {"step_ms": step_ms, "busy_share": "not measured"}
    busy = {"busy_share": "not measured"}
    try:
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and e.name not in host)
    except AttributeError as err:     # a profiler without kernel spans
        busy["busy_error"] = str(err)
        spans = []
    if spans:
        busy_us, end = 0.0, -math.inf
        for lo, hi in spans:
            busy_us += max(0.0, hi - max(lo, end))
            end = max(end, hi)
        busy = {"busy_ms": busy_us / 1e3,
                "busy_share": busy_us / 1e3 / step_ms}
    events.sort(key=dev, reverse=True)
    return {"step_ms": step_ms, "device_ms": kernel_ms, **busy,
            "top": [{"name": e.key[:90], "ms": dev(e), "calls": e.count}
                    for e in events[:top]]}


def phase_ea_train(torch) -> dict:
    """The I_ea trainer at full width: configs/ea_large.yaml's model
    (HuBERT-large) with a 100 × 80 codebook, B = 16 × 5 s (80 003
    samples, the CLI's max_length), cos_sim, one fixed batch on the card.
    bf16 compute: 2 warm-up steps and 10 timed (CUDA events per step:
    median, min, max), then 10 more with the nonfinite guard on (one flag
    read per step); f32 compute: 1 warm-up and 3 timed. Each: ms per step,
    trained audio-s per s, peak memory, beside the step's bound; one more
    bf16 step under torch.profiler (`_profile_step`). Gates: every loss
    finite, the last below the first."""
    from speech_inpainting_torch.convert.from_jax import trainable_hubert
    from speech_inpainting_torch.models.hubert import HubertConfig
    from speech_inpainting_torch.testing import hubert_tree
    from speech_inpainting_torch.train import ea
    rng = np.random.default_rng(SEED + 150)
    tree = _trained_like(hubert_tree(HubertConfig.large(), 80, rng), rng)
    centroids = rng.standard_normal((100, 80)).astype(np.float32)
    B = 16
    host = _ea_batch(rng, B, EA_SAMPLES, 100)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in host.items()}
    audio_s = B * 5.0
    rows, ok = {}, True
    for name, dtype, warmup, iters in (("bf16", torch.bfloat16, 2, 10),
                                       ("f32", torch.float32, 1, 3)):
        hcfg = HubertConfig.large(dtype=dtype)
        guards = (0, 5) if name == "bf16" else (0,)
        for guard in guards:
            cfg = ea.EAConfig(skip_nonfinite=guard)
            torch.cuda.reset_peak_memory_stats()
            state = ea.create_state(cfg, trainable_hubert(
                hcfg, tree, 80, device="cuda"))
            step = ea.make_train_step(cfg, centroids, "cuda")
            t0 = time.perf_counter()
            ms, losses = _timed_steps(torch, step, state, batch, warmup,
                                      iters)
            wall = (time.perf_counter() - t0) / (warmup + iters)
            med = float(np.median(ms))
            key = name + ("_guard" if guard else "")
            rows[key] = {
                "ms_per_step_median": med, "ms_per_step_min": min(ms),
                "ms_per_step_max": max(ms), "ms_per_step": ms,
                "wall_s_per_step_incl_warmup": wall,
                "audio_seconds_per_second": audio_s / (med / 1e3),
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                "losses": losses,
                **ea_step_bound_ms(hcfg, B, EA_SAMPLES,
                                   "bfloat16" if name == "bf16"
                                   else "float32")}
            ok &= (all(np.isfinite(losses)) and losses[-1] < losses[0])
            if key == "bf16":
                rows["bf16_profile"] = _profile_step(torch, step, state,
                                                     batch)
            del state, step
    row = {"phase": "ea_train", "hubert": "large", "B": B,
           "samples": EA_SAMPLES, "loss": "cos_sim", "codebook": [100, 80],
           "audio_seconds_per_step": audio_s, **rows, "ok": ok}
    emit(row)
    if not ok:
        raise AssertionError("I_ea training run check failed")
    return row


def phase_train_ea_cli(torch, d: Path) -> dict:
    """`train_ea.main` and then `predict_ea.main` on the card, as a user
    runs them, on files written to the directory d: 32 synthetic
    5 s 16 kHz wavs with their `_labels.npy`, train and valid splits, a
    100 × 80 .npy codebook, an HF HuBERT-large directory (config.json +
    pytorch_model.bin) and a V1 `g_*` file. `--hubert-type large
    --pretrained DIR --batch-size 16 --epochs 1` (2 steps, bf16); again
    with `--epochs 1 --f32`, which resumes from ea_00000002 and ends at
    step 4 (`--epochs` counts this run's epochs, as in the JAX loop); then
    `predict_ea --hubert-checkpoint last_00000000` with labels (three
    vocoder calls, 216 K1 launches). Checks: every checkpoint and artifact
    written, the resume, K1's launches, and the head's output from `last_`
    equal to the trained module's in memory (atol 1e-6, f32). The corpus,
    the codebook and the HF directory stay in d for `dist_world1`; the
    checkpoints and predictions go at the end."""
    import importlib.util
    import shutil
    from scipy.io import wavfile
    from speech_inpainting_torch.cli import predict_ea, train_ea
    from speech_inpainting_torch.device import full_f32
    from speech_inpainting_torch.models.hifigan import HiFiGANConfig
    from speech_inpainting_torch.models.hubert import HubertConfig
    from speech_inpainting_torch.ops.resblock import fused_resblock1
    from speech_inpainting_torch.testing import (generator_state_dict,
                                                 generator_tree,
                                                 hubert_model_tree,
                                                 synthetic_batch,
                                                 synthetic_utterance,
                                                 write_hf_hubert)
    figures = importlib.util.find_spec("matplotlib") is not None
    rng = np.random.default_rng(SEED + 160)
    hcfg = HubertConfig.large()
    t_start = time.perf_counter()
    (d / "wavs").mkdir()
    (d / "labels").mkdir()
    names = [f"utt{i:02d}" for i in range(32)]
    for n in names:
        wavfile.write(d / "wavs" / f"{n}.wav", 16000, (
            synthetic_utterance(rng, 5.0) * 32767).astype(np.int16))
        np.save(d / "labels" / f"{n}_labels.npy",
                rng.integers(0, 100, 249).astype(np.int32))
    (d / "train.txt").write_text("\n".join(names) + "\n")
    (d / "valid.txt").write_text("\n".join(names[:4]) + "\n")
    np.save(d / "km.npy", rng.standard_normal((100, 80)).astype(np.float32))
    write_hf_hubert(d / "hf", _trained_like(hubert_model_tree(hcfg, rng),
                                            rng), hcfg)
    gcfg = HiFiGANConfig()
    torch.save({"generator": generator_state_dict(
        generator_tree(gcfg, rng), gcfg)}, d / "g_00000001")
    w22 = synthetic_batch(rng, 1, 4.0)[0][0]
    wavfile.write(d / "utt.wav", 22050, (w22 * 32767).astype(np.int16))
    np.save(d / "pred_labels.npy", rng.integers(0, 100, 200))
    setup_s = time.perf_counter() - t_start
    common = ["--wavs", str(d / "wavs"), "--split", str(d / "train.txt"),
              "--valid-split", str(d / "valid.txt"), "--labels-dir",
              str(d / "labels"), "--kmeans", str(d / "km.npy"),
              "--checkpoint-path", str(d / "ckpt"), "--hubert-type",
              "large", "--pretrained", str(d / "hf"), "--batch-size",
              "16", "--epochs", "1", "--device", "cuda"]
    t0 = time.perf_counter()
    first = train_ea.main(common)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    first_step = first.step
    after_first = sorted(p.name for p in (d / "ckpt").iterdir())
    del first
    t0 = time.perf_counter()
    second = train_ea.main(common + ["--f32"])
    torch.cuda.synchronize()
    second_s = time.perf_counter() - t0
    ckpts = sorted(p.name for p in (d / "ckpt").iterdir())
    # the head's output from last_ against the module in memory, f32
    wav = torch.as_tensor(synthetic_utterance(rng, 2.0),
                          device="cuda")[None]
    loaded = predict_ea.load_trained_hubert(
        d / "ckpt" / "last_00000000", hcfg, "cuda")
    with torch.no_grad(), full_f32():
        head_gap = (loaded(wav) - second.model(wav)).abs().max().item()
    end_step = second.step
    del second, loaded
    fused_resblock1.launches = 0
    t0 = time.perf_counter()
    predict_ea.main(["--wav", str(d / "utt.wav"), "--start-sec", "1.5",
                     "--end-sec", "1.7", "--labels",
                     str(d / "pred_labels.npy"), "--hubert-checkpoint",
                     str(d / "ckpt" / "last_00000000"), "--hubert-type",
                     "large", "--hifigan-checkpoint",
                     str(d / "g_00000001"), "--kmeans",
                     str(d / "km.npy"), "--out", str(d / "pred"),
                     "--device", "cuda"], figures=figures)
    predict_s = time.perf_counter() - t0
    launches = fused_resblock1.launches
    written = sorted(p.name for p in (d / "pred" / "utt").iterdir())
    for out in ("ckpt", "pred"):
        shutil.rmtree(d / out)
    want = ["orig.wav", "masked.wav", "hifi_masked.wav", "inpainted.wav",
            "expected_inpaint.wav"]
    if figures:
        want += ["masked.png", "inpainted.png", "expected.png"]
    ok = (first_step == 2 and after_first == ["ea_00000002", "last_00000000"]
          and end_step == 4 and ckpts == ["ea_00000002", "ea_00000004",
                                          "last_00000000"]
          and head_gap <= 1e-6 and set(want) <= set(written)
          and launches == 3 * 72)
    row = {"phase": "train_ea_cli", "wavs": 32, "seconds_per_wav": 5.0,
           "steps_first_run": first_step, "end_step_resumed": end_step,
           "checkpoints": ckpts, "head_gap_last_vs_memory": head_gap,
           "written": written, "launches": launches,
           "expected_launches": 3 * 72, "setup_seconds": setup_s,
           "train_seconds_first": first_s, "train_seconds_resumed": second_s,
           "predict_seconds": predict_s, "ok": ok}
    emit(row)
    if not ok:
        raise AssertionError("train_ea CLI check failed")
    return row


# ------------------------------------------------------ the GAN trainer

GAN_LR = 2e-4        # GANConfig's learning rate (configs/hifigan_*.json)
GAN_SR = 22050
GAN_SEG = 44288      # configs/hifigan_ft_modified.json's segment_size
GAN_B = 16           # its batch_size


def _conv_len(n, k, s, p):
    return (n + 2 * p - k) // s + 1


def gan_flops(gcfg, B, seg, frames=None) -> dict:
    """Forward FLOP (a multiply-add counts 2) of the generator on B crops of
    `seg` samples from `frames` input frames (the VOCODER_MEL_22K frames of
    the crop where None), and of the MPD and MSD together on B
    waveforms. An ISTFTGeneratorConfig's generator ends in conv_post's
    n_fft + 2 channels and the inverse DFT's product (n_fft + 2 by n_fft
    a frame)."""
    T = frames or 1 + (seg + 768 - 1024) // 256
    c = gcfg.upsample_initial_channel
    gen = 2 * B * T * c * gcfg.in_dim * 7
    ch = c
    for i, (u, k) in enumerate(zip(gcfg.upsample_rates,
                                   gcfg.upsample_kernel_sizes)):
        ch = c // 2 ** (i + 1)
        gen += 2 * B * T * 2 * ch * ch * k       # each input spreads ch·k
        T *= u
        for rk, rd in zip(gcfg.resblock_kernel_sizes,
                          gcfg.resblock_dilation_sizes):
            gen += 2 * B * T * ch * ch * rk * 2 * len(rd)
    n_fft = getattr(gcfg, "istft_n_fft", None)
    if n_fft is None:
        gen += 2 * B * T * ch * 7
    else:
        gen += 2 * B * T * (n_fft + 2) * (ch * 7 + n_fft)
    disc = 0
    for p in (2, 3, 5, 7, 11):
        H, c_in = -(-seg // p), 1
        for c_out, s, pad, k in ((32, 3, 2, 5), (128, 3, 2, 5),
                                 (512, 3, 2, 5), (1024, 3, 2, 5),
                                 (1024, 1, 2, 5), (1, 1, 1, 3)):
            H = _conv_len(H, k, s, pad)
            disc += 2 * B * H * p * c_out * c_in * k
            c_in = c_out
    L = seg
    for i in range(3):
        if i:
            L = _conv_len(L, 4, 2, 2)
        n, c_in = L, 1
        for f, k, s, g, pd in ((128, 15, 1, 1, 7), (128, 41, 2, 4, 20),
                               (256, 41, 2, 16, 20), (512, 41, 4, 16, 20),
                               (1024, 41, 4, 16, 20), (1024, 41, 1, 16, 20),
                               (1024, 5, 1, 1, 2), (1, 3, 1, 1, 1)):
            n = _conv_len(n, k, s, pd)
            disc += 2 * B * n * f * (c_in // g) * k
            c_in = f
    return {"generator": gen, "discriminators": disc}


def gan_step_bound_ms(gcfg, B, seg, n_params, disc_bf16,
                      frames=None) -> dict:
    """The least time of one GAN step: its FLOP over the peak rate of each
    part's type (the generator in full f32; the discriminators in f32, or
    bf16 on the tensor cores with disc_bf16), plus AdamW's bytes over the
    memory rate. FLOP: the generator's forward and backward (3× its
    forward); the discriminators' D phase (real and fake forward, weight
    and input gradients: 6× one forward over B) and G phase (real and
    fake forward, the fake's input gradient only: 3×). `frames`: the
    generator's input frames (gan_flops)."""
    f = gan_flops(gcfg, B, seg, frames)
    gen_ms = 1e3 * 3 * f["generator"] / PEAK_FLOPS["float32"]
    disc_ms = 1e3 * 9 * f["discriminators"] / PEAK_FLOPS[
        "bfloat16" if disc_bf16 else "float32"]
    adamw_ms = 1e3 * 7 * 4 * n_params / PEAK_BYTES
    return {"generator_forward_tflop": f["generator"] / 1e12,
            "discriminators_forward_tflop": f["discriminators"] / 1e12,
            "step_tflop": (3 * f["generator"] + 9 * f["discriminators"])
            / 1e12, "params_millions": n_params / 1e6,
            "bound_by": "operations",
            "bound_ms": gen_ms + disc_ms + adamw_ms}


def _gan_cfg(path, seg, mask_len=20, **gan):
    from speech_inpainting_torch.models.hifigan import HiFiGANConfig
    from speech_inpainting_torch.train.gan import GANConfig
    from speech_inpainting_torch.train.hifigan import HiFiGANTrainConfig
    gcfg = HiFiGANConfig.from_dict(json.loads(path.read_text()))
    return HiFiGANTrainConfig(gan=GANConfig(batched_disc=True, **gan),
                              hifigan=gcfg, segment_size=seg,
                              mask_len=mask_len)


def _gan_trees(torch, gcfg, rng):
    """One seeded tree of all three modules: a generator whose weights
    carry the signal (testing.generator_tree's carry=True), the
    discriminators at the port's init."""
    from speech_inpainting_torch.convert.from_jax import (mpd_from_jax,
                                                          mpd_tree,
                                                          msd_from_jax,
                                                          msd_tree,
                                                          spectral_tree)
    from speech_inpainting_torch.testing import generator_tree
    seed = int(rng.integers(1 << 30))
    mpd = mpd_from_jax(device="cpu",
                       generator=torch.Generator().manual_seed(seed))
    msd = msd_from_jax(device="cpu",
                       generator=torch.Generator().manual_seed(seed + 1))
    return (generator_tree(gcfg, rng, carry=True), mpd_tree(mpd),
            msd_tree(msd), spectral_tree(msd))


def _gan_state(torch, tcfg, trees, device, f64=False, icfg=None):
    """A GANTrainState on `device` from the trees, the generator an iSTFT
    one where `icfg` (an ISTFTGeneratorConfig) is given; f64 computes and
    stores everything in float64 (the reference step)."""
    from speech_inpainting_torch.convert.from_jax import (
        mpd_from_jax, msd_from_jax, trainable_generator,
        trainable_istft_generator)
    from speech_inpainting_torch.train.gan import create_gan_state
    g, mp, mv, spec = trees
    ddt = torch.bfloat16 if tcfg.gan.disc_bf16 else torch.float32
    gen = (trainable_generator(tcfg.hifigan, g, device=device) if icfg is None
           else trainable_istft_generator(icfg, g, device=device))
    mods = (gen, mpd_from_jax(mp, dtype=ddt, device=device),
            msd_from_jax(mv, spec, dtype=ddt, device=device))
    if f64:
        for m in mods:
            m.double()
            for c in m.modules():
                if hasattr(c, "dtype"):
                    c.dtype = torch.float64
    return create_gan_state(tcfg.gan, *mods)


def _gan_audio(rng, B, seg):
    from speech_inpainting_torch.testing import synthetic_batch
    return synthetic_batch(rng, B, seg / GAN_SR + 0.01)[0][:, None, :seg]


def _gan_named(torch, state) -> dict:
    """{(kind, name): float64 CPU tensor} of a state's parameters, their
    gradients, both AdamW moments and the MSD's u/v."""
    out = {}
    for mname in ("generator", "mpd", "msd"):
        module = getattr(state, mname)
        opt = state.g_opt if mname == "generator" else state.d_opt
        for n, p in module.named_parameters():
            st = opt.state.get(p, {})
            for kind, t in (("param", p), ("grad", p.grad),
                            ("mu", st.get("exp_avg")),
                            ("nu", st.get("exp_avg_sq"))):
                if t is not None:
                    out[(kind, f"{mname}.{n}")] = t.detach().double().cpu()
        if mname == "msd":
            for n, b in module.named_buffers():
                out[("u/v", f"msd.{n}")] = b.double().cpu()
    return out


def _gan_tensors(torch, state) -> dict:
    """_gan_named with "kind name" keys."""
    return {f"{k} {n}": t for (k, n), t in _gan_named(torch, state).items()}


def _gan_gaps(a, b, r, kink: dict | None = None) -> dict:
    """`a` against `b` (`_gan_tensors` of two float32 states after the same
    step from the same start: the card's and the CPU's), with `r`, the
    CPU's float64 step, beside them, by testing.parity_gate per tensor
    (every parameter, gradient, AdamW moment and u/v): an element passes
    within rtol 2e-5, atol 2e-6 of the CPU's, or within its tensor's
    float64 tolerance (1e-4 of its largest magnitude, or 4 × the CPU's
    own float32 gap) of float64. Each tensor of more than NOISE_SMALL
    elements may hold testing.NOISE.share of its elements outside both, and
    every outside element must lie within NOISE.excess × the tolerance
    (NOISE.small_excess × in a smaller tensor; the limits are printed
    with the readings): a leaky ReLU input within rounding of
    its kink (several a step at these widths) takes its slope by the
    rounding's sign and moves every gradient behind it. A parameter
    element outside whose gradient is zero up to rounding (its float64
    first moment within the moment's tolerance of zero) is held to AdamW's
    noise bound instead. `kink` ({"kind name": mask}, `_kink_flips`)
    marks the elements behind a discriminator input whose slope the two
    runs took apart: its parameters are held to that bound too (one AdamW
    step moves an element by at most 1.005·lr whatever its gradient), its
    gradients and moments are counted apart and not held."""
    from speech_inpainting_torch.testing import (ADAMW_NOISE, NOISE,
                                                 parity_gate,
                                                 zero_up_to_rounding)
    kink = kink or {}
    mu = [k for k in b if k.startswith("mu ")]
    zero = zero_up_to_rounding({k: b[k] for k in mu}, {k: r[k] for k in mu})
    zero = {"param " + k[3:]: m for k, m in zero.items()}
    for k, m in kink.items():
        if k.startswith("param "):
            zero[k] = zero[k] | m
    params = [k for k in b if k.startswith("param ")]
    rest = [k for k in b if not k.startswith("param ")]
    reps = [parity_gate(*({k: t[k] for k in keys} for t in (a, b, r)),
                        exempt=ex, bound=bound)
            for keys, ex, bound in (
                (params, zero, ADAMW_NOISE * GAN_LR),
                (rest, {k: m for k, m in kink.items() if k in rest}, None))]
    rep = {"f64": [n for x in reps for n in x["f64"]],
           **{key: {n: v for x in reps for n, v in x[key].items()}
              for key in ("outside", "exempt")},
           **{key: max(x[key] for x in reps)
              for key in ("share_max", "excess_max", "small_excess_max")},
           "failed": [n for x in reps for n in x["failed"]]}
    kinds = sorted({k.split(" ")[0] for k in rep["f64"]})
    return {"outside": rep["outside"], "exempt": rep["exempt"],
            "share_max": rep["share_max"], "excess_max": rep["excess_max"],
            "small_excess_max": rep["small_excess_max"],
            "limits": {"share": NOISE.share, "excess": NOISE.excess,
                       "small_excess": NOISE.small_excess},
            "f64_tensor_counts": {k: sum(n.startswith(k + " ")
                                         for n in rep["f64"])
                                  for k in kinds},
            "failed": rep["failed"], "ok": not rep["failed"]}


@contextlib.contextmanager
def _d_step_preacts(torch, state):
    """Yields {(discriminator, j): float64 CPU tensor}, filled by the next
    GAN step: the output of `convs.{j}` (the input of a leaky ReLU) of
    every MPD and MSD discriminator in the discriminators' step, the calls
    made while their parameters take gradients (the generator's step runs
    them frozen), joined on the batch axis (MSD scale 0 takes y and ŷ in
    two calls)."""
    seen, handles = {}, []
    for mname in ("mpd", "msd"):
        for i, d in enumerate(getattr(state, mname).discriminators):
            for j, conv in enumerate(d.convs):
                def hook(m, args, out, key=(f"{mname}.discriminators.{i}", j)):
                    if m.bias.requires_grad:
                        seen.setdefault(key, []).append(
                            out.detach().double().cpu())
                handles.append(conv.register_forward_hook(hook))
    try:
        yield seen
    finally:
        for h in handles:
            h.remove()
        for key, outs in seen.items():
            seen[key] = torch.cat(outs)


def _kink_flips(torch, state, card: dict, cpu: dict, ref: dict) -> tuple:
    """The discriminators' leaky-ReLU inputs (`_d_step_preacts` of the
    card's, the CPU's and the CPU's float64 step) on which the two float32
    runs took different slopes (one > 0, the other not). A flip whose
    float64 value lies within rounding of the kink (|z64| within
    testing.noise_tolerance of its layer's output in that batch row, the
    real rows and the generated ones apart; margin = |z64| / that ≤ 1)
    explains a gap in every gradient behind it: channel c of that
    conv's parameters (the whole of a spectral-normed weight, whose σ
    couples its rows) and the whole of the discriminator's earlier convs,
    with their moments and updated values. Returns (masks {"kind name":
    bool array} of those elements, report: the flips, those within
    rounding, the largest margin of each, and the first eight)."""
    from speech_inpainting_torch.testing import noise_tolerance
    masks, flips = {}, []
    for (disc, j), z64 in ref.items():
        zc, zp = card[(disc, j)], cpu[(disc, j)]
        tols = [noise_tolerance(a, b) for a, b in zip(zp, z64)]
        for idx in ((zc > 0) != (zp > 0)).nonzero().tolist():
            tol = tols[idx[0]]
            margin = float(z64[tuple(idx)].abs()) / tol
            flips.append({"discriminator": disc, "conv": j,
                          "row": idx[0], "channel": idx[1], "z_f64": float(z64[tuple(idx)]),
                          "z_card": float(zc[tuple(idx)]),
                          "z_cpu": float(zp[tuple(idx)]), "tolerance": tol,
                          "margin": margin})
            if margin > 1:
                continue
            mname, rest = disc.split(".", 1)
            d = getattr(state, mname).get_submodule(rest)
            for k in range(j + 1):
                for n, p in d.convs[k].named_parameters():
                    m = masks.setdefault(f"{disc}.convs.{k}.{n}",
                                         np.zeros(tuple(p.shape), bool))
                    if k < j or n == "weight_orig":
                        m[...] = True
                    else:
                        m[idx[1]] = True
    masks = {f"{kind} {n}": m for n, m in masks.items()
             for kind in ("param", "grad", "mu", "nu")}
    within = [f for f in flips if f["margin"] <= 1]
    report = {"flips": len(flips), "flips_within_rounding": len(within),
              "margin_max_within": max((f["margin"] for f in within),
                                       default=None),
              "margin_min_outside": min((f["margin"] for f in flips
                                         if f["margin"] > 1), default=None),
              "first": sorted(flips, key=lambda f: f["margin"])[:8]}
    return masks, report


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def phase_gan_step_parity(torch) -> dict:
    """The GAN step at full width on the card against the CPU:
    configs/hifigan_v1.json (512 channels), the full MPD and MSD, the
    vanilla recipe, B = 2 × 8192, f32, batched_disc on, steps_per_epoch =
    1 (so the second update runs at the decayed rate), one seeded tree
    (`_gan_trees`). One step on the card and on the CPU, and in float64
    on the CPU: loss_disc, loss_gen_all and mel_error rel 1e-5; every
    parameter, gradient, moment and u/v by `_gan_gaps`. Then on the card:
    a second step, whose update must be the decayed rate's (conv_post's
    kernel direction v, computed in float64 as p − lr·0.999·u from its own
    moments, ten times closer than undecayed lr gives: the rates differ by
    2e-7 of a step, a few ulps of v); a nan batch with skip_nonfinite after
    a finite step (parameters, moments and counts bit-equal, one skip, the
    u/v of scale 0's seven wide convs advanced: conv_post's u is its one
    output, 1, and its v then W's own direction); and batched_disc off
    against on (losses rel 1e-6; every tensor by `_gan_gaps` beside the
    CPU's float64 step)."""
    from speech_inpainting_torch.train.hifigan import make_vanilla_step
    rng = np.random.default_rng(SEED + 170)
    tcfg = _gan_cfg(CONFIGS / "hifigan_v1.json", 8192, steps_per_epoch=1)
    trees = _gan_trees(torch, tcfg.hifigan, rng)
    batch = {"audio": _gan_audio(rng, 2, 8192)}
    step = make_vanilla_step(tcfg)
    t0 = time.perf_counter()
    card, mc = step(_gan_state(torch, tcfg, trees, "cuda"), batch)
    mc = {k: float(v) for k, v in mc.items()}
    cpu, mp = step(_gan_state(torch, tcfg, trees, "cpu"), batch)
    mp = {k: float(v) for k, v in mp.items()}
    batch64 = {"audio": batch["audio"].astype(np.float64)}
    ref, _ = step(_gan_state(torch, tcfg, trees, "cpu", f64=True), batch64)
    r = _gan_tensors(torch, ref)
    gaps = _gan_gaps(_gan_tensors(torch, card), _gan_tensors(torch, cpu), r)
    del cpu, ref
    rels = {k: _rel(mc[k], mp[k]) for k in mc}
    # the second update, at lr·0.999 (its count is 1)
    v = card.generator.conv_post.weight_v
    before = v.detach().double().clone()
    batch2 = {"audio": _gan_audio(rng, 2, 8192)}
    card, _ = step(card, batch2)
    st = card.g_opt.state[v]
    u = ((st["exp_avg"].double() / (1 - 0.8 ** 2))
         / ((st["exp_avg_sq"].double() / (1 - 0.99 ** 2)).sqrt() + 1e-8)
         + 0.01 * before)
    lr2 = float(np.float32(GAN_LR) * np.float32(0.999))
    decay = {key: float((v.detach().double() - (before - lr * u)).abs().max())
             for key, lr in (("decayed", lr2), ("undecayed", GAN_LR))}
    decay_ok = decay["decayed"] * 10 < decay["undecayed"]
    del card
    # a nan batch under the guard, after a finite step
    from speech_inpainting_torch.train.hifigan import make_vanilla_step as mk
    gcfg = dataclasses.replace(tcfg, gan=dataclasses.replace(
        tcfg.gan, skip_nonfinite=5))
    gstep = mk(gcfg)
    guarded, _ = gstep(_gan_state(torch, gcfg, trees, "cuda"), batch)
    snap = {k: v.clone() for k, v in _gan_named(torch, guarded).items()
            if k[0] != "grad"}
    counts = [s["step"] for o in (guarded.g_opt, guarded.d_opt)
              for s in o.state.values()]
    bad = {"audio": batch2["audio"].copy()}
    bad["audio"][1, 0, 100] = np.nan
    guarded, mb = gstep(guarded, bad)
    after = _gan_named(torch, guarded)
    skip_equal = all(torch.equal(after[k], v) for k, v in snap.items()
                     if k[0] != "u/v") and counts == [
        s["step"] for o in (guarded.g_opt, guarded.d_opt)
        for s in o.state.values()]
    uv_moved = sum(not torch.equal(after[k], v) for k, v in snap.items()
                   if k[0] == "u/v")
    skips = (int(mb["nonfinite_skips"]), guarded.g_guard.notfinite_count,
             guarded.d_guard.notfinite_count)
    del guarded
    # batched_disc off against on, on the card
    ucfg = dataclasses.replace(tcfg, gan=dataclasses.replace(
        tcfg.gan, batched_disc=False))
    on_, m_on = step(_gan_state(torch, tcfg, trees, "cuda"), batch)
    off, m_off = make_vanilla_step(ucfg)(
        _gan_state(torch, ucfg, trees, "cuda"), batch)
    batched_rel = max(_rel(float(m_on[k]), float(m_off[k])) for k in m_on)
    batched = _gan_gaps(_gan_tensors(torch, off), _gan_tensors(torch, on_),
                        r)
    del on_, off, r
    ok = (max(rels[k] for k in ("loss_disc", "loss_gen_all", "mel_error"))
          <= 1e-5 and gaps["ok"] and decay_ok and skip_equal
          and uv_moved == 14 and skips == (1, 1, 1) and batched_rel <= 1e-6
          and batched["ok"])
    row = {"phase": "gan_step_parity", "config": "hifigan_v1.json",
           "B": 2, "samples": 8192, "dtype": "float32",
           "metrics_card": mc, "metrics_cpu": mp, "metrics_rel": rels,
           "card_vs_cpu": gaps, "second_update_gap": decay,
           "skip_bit_equal": skip_equal, "skips": skips,
           "uv_tensors_advanced_on_skip": uv_moved,
           "batched_vs_two_calls_metrics_rel": batched_rel,
           "two_calls_vs_batched": batched,
           "seconds": time.perf_counter() - t0, "ok": ok}
    emit(row)
    if not ok:
        raise AssertionError("GAN step parity check failed")
    return row


def phase_gan_train(torch) -> dict:
    """The modified recipe at full width: configs/hifigan_ft_modified.json
    (V1, 512 channels, the full MPD and MSD), B = 16 × 44 288 samples
    (32.1 s of audio a step), mask_len 20, a 100 × 80 codebook of the
    batch's own hop-441 mel frames moved by noise, batched_disc on, one
    fixed batch, the CLI's init (generator from seed 1234, discriminators
    from 1 and 2). Eight f32 steps, then eight with disc_bf16 from the same
    init: ms per step by CUDA events (the first step, with cuDNN's
    algorithm choice, apart; median, min and max of the other seven),
    trained audio-s per s, peak memory, the bound (`gan_step_bound_ms`);
    one more f32 step under torch.profiler. Gates: every loss finite, and
    mel_error over each run's last three steps below its first step's."""
    from speech_inpainting_torch.convert.from_jax import trainable_generator
    from speech_inpainting_torch.ops.mel import (MODIFIED_MEL_22K,
                                                 mel_spectrogram)
    from speech_inpainting_torch.train.gan import (create_gan_state,
                                                   default_discriminators)
    from speech_inpainting_torch.train.hifigan import make_modified_step
    rng = np.random.default_rng(SEED + 180)
    audio = _gan_audio(rng, GAN_B, GAN_SEG)
    frames = pinned(mel_spectrogram, torch.as_tensor(audio[:, 0]),
                    MODIFIED_MEL_22K).transpose(1, 2).reshape(-1, 80).numpy()
    centroids = (frames[rng.choice(len(frames), 100, replace=False)]
                 + 0.05 * rng.standard_normal((100, 80))).astype(np.float32)
    n441 = MODIFIED_MEL_22K.num_frames(GAN_SEG) - 20
    batch = {"audio": torch.as_tensor(audio, device="cuda"),
             "mask_start": torch.as_tensor(rng.integers(0, n441, GAN_B)
                                           .astype(np.int32), device="cuda")}
    audio_s = GAN_B * GAN_SEG / GAN_SR
    rows, ok = {}, True
    for name, bf16 in (("f32", False), ("bf16_disc", True)):
        tcfg = _gan_cfg(GAN_CONFIG, GAN_SEG, disc_bf16=bf16)
        torch.cuda.reset_peak_memory_stats()
        gen = trainable_generator(
            tcfg.hifigan, device="cuda",
            generator=torch.Generator().manual_seed(1234))
        state = create_gan_state(tcfg.gan, gen,
                                 *default_discriminators(tcfg.gan, "cuda"))
        n_params = sum(p.numel() for m in (state.generator, state.mpd,
                                           state.msd)
                       for p in m.parameters())
        step = make_modified_step(tcfg, centroids)
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(8)]
        metrics = []
        t0 = time.perf_counter()
        for a, b in events:
            a.record()
            state, m = step(state, batch)
            b.record()
            metrics.append(m)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ms = [a.elapsed_time(b) for a, b in events]
        metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
        med = float(np.median(ms[1:]))
        mel = [m["mel_error"] for m in metrics]
        finite = all(np.isfinite(v) for m in metrics for v in m.values())
        ok &= finite and max(mel[-3:]) < mel[0]
        rows[name] = {
            "first_step_ms": ms[0], "ms_per_step_median": med,
            "ms_per_step_min": min(ms[1:]), "ms_per_step_max": max(ms[1:]),
            "ms_per_step": ms, "wall_s_8_steps": wall,
            "audio_seconds_per_second": audio_s / (med / 1e3),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "mel_error": mel, "loss_disc": [m["loss_disc"] for m in metrics],
            "loss_gen_all": [m["loss_gen_all"] for m in metrics],
            **gan_step_bound_ms(tcfg.hifigan, GAN_B, GAN_SEG, n_params,
                                bf16)}
        if name == "f32":
            rows["f32_profile"] = _profile_step(torch, step, state, batch)
        del state, step, gen
    row = {"phase": "gan_train", "config": "hifigan_ft_modified.json",
           "recipe": "modified", "B": GAN_B, "samples": GAN_SEG,
           "mask_len": 20, "codebook": [100, 80],
           "audio_seconds_per_step": audio_s, **rows, "ok": ok}
    emit(row)
    if not ok:
        raise AssertionError("GAN training run check failed")
    return row


def phase_train_hifigan_cli(torch) -> dict:
    """`train_hifigan.main`, then `predict_ea.main` and `vocode.main` from
    what it trained, on the card, as a user runs them, on files written to
    a temporary directory: 32 synthetic 3 s 22.05 kHz wavs (train
    filelist), 16 more (valid filelist), a 100 × 80 .npy codebook.
    `--modified --kmeans km.npy --config configs/hifigan_ft_modified.json
    --batch-size 16 --epochs 1 --validation-interval 2` (2 steps, one
    validation sweep of one B = 16 batch through the folded generator: 72
    K2 launches); the same command again, which resumes 2 → 4 (another
    sweep); then `predict_ea --hifigan-checkpoint g_00000004` (a
    HuBERT-base CustomModel .pt, labels given: 216 K1 launches) and
    `vocode wav2wav --checkpoint g_00000004` on two of the wavs (72 K2
    launches per forward). Gates: the checkpoints, the resume, the
    launches, every artifact written, and the generator loaded from g_
    equal to the trained module's fold() (waveform gap 0, at most 1e-6)."""
    import tempfile
    from scipy.io import wavfile
    from speech_inpainting_torch.cli import predict_ea, train_hifigan, vocode
    from speech_inpainting_torch.convert.hifigan_torch import (
        load_generator_checkpoint)
    from speech_inpainting_torch.device import full_f32
    from speech_inpainting_torch.models.hifigan import Generator
    from speech_inpainting_torch.models.hubert import HubertConfig
    from speech_inpainting_torch.ops.resblock import (fused_resblock1,
                                                      fused_resblock_step)
    from speech_inpainting_torch.testing import (custom_model_state_dict,
                                                 hubert_tree,
                                                 synthetic_batch)
    rng = np.random.default_rng(SEED + 190)
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        (d / "wavs").mkdir()
        (d / "voc").mkdir()
        wavs = synthetic_batch(rng, 48, 3.0)[0]
        names = [f"utt{i:02d}" for i in range(48)]
        for n, w in zip(names, wavs):
            _write_wav(d / "wavs" / f"{n}.wav", w, GAN_SR)
        for n in names[:2]:
            _write_wav(d / "voc" / f"{n}.wav", wavs[names.index(n)], GAN_SR)
        (d / "train.txt").write_text("\n".join(names[:32]) + "\n")
        (d / "valid.txt").write_text("\n".join(names[32:]) + "\n")
        np.save(d / "km.npy", rng.standard_normal((100, 80)).astype(
            np.float32) - 5.0)
        hcfg = HubertConfig.base()
        torch.save(custom_model_state_dict(hubert_tree(hcfg, 80, rng), hcfg),
                   d / "best.pt")
        np.save(d / "labels.npy", rng.integers(0, 100, 200))
        setup_s = time.perf_counter() - t_start
        cmd = ["--wavs", str(d / "wavs"), "--filelist", str(d / "train.txt"),
               "--valid-filelist", str(d / "valid.txt"), "--config",
               str(GAN_CONFIG), "--modified", "--kmeans", str(d / "km.npy"),
               "--checkpoint-path", str(d / "ckpt"), "--batch-size", "16",
               "--epochs", "1", "--validation-interval", "2", "--device",
               "cuda"]
        runs = []
        for _ in range(2):
            fused_resblock_step.launches = 0
            t0 = time.perf_counter()
            state = train_hifigan.main(cmd)
            torch.cuda.synchronize()
            runs.append({"seconds": time.perf_counter() - t0,
                         "end_step": state.step,
                         "validation_k2_launches":
                             fused_resblock_step.launches,
                         "checkpoints": sorted(
                             p.name for p in (d / "ckpt").iterdir())})
        g_file = d / "ckpt" / "g_00000004"
        gcfg = state.generator.cfg
        sweep = _sweep_check(torch, state.generator, wavs[32:48])
        mel = torch.as_tensor(rng.standard_normal((1, 80, 64)).astype(
            np.float32) - 5.0, device="cuda")
        loaded = load_generator_checkpoint(g_file, gcfg, device="cuda",
                                           cls=Generator)
        with torch.no_grad(), full_f32():
            fold_gap = float((loaded(mel) - state.generator.fold()(mel))
                             .abs().max())
        del state, loaded
        fused_resblock1.launches = 0
        t0 = time.perf_counter()
        predict_ea.main(["--wav", str(d / "voc" / "utt00.wav"),
                         "--start-sec", "1.5", "--end-sec", "1.7",
                         "--labels", str(d / "labels.npy"),
                         "--hubert-checkpoint", str(d / "best.pt"),
                         "--hubert-type", "base", "--hifigan-checkpoint",
                         str(g_file), "--kmeans", str(d / "km.npy"),
                         "--out", str(d / "pred"), "--device", "cuda"],
                        figures=False)
        predict_s = time.perf_counter() - t0
        k1 = fused_resblock1.launches
        predicted = sorted(p.name for p in (d / "pred" / "utt00").iterdir())
        fused_resblock_step.launches = 0
        t0 = time.perf_counter()
        vocode.main(["wav2wav", "--input-dir", str(d / "voc"),
                     "--checkpoint", str(g_file), "--config",
                     str(GAN_CONFIG), "--out", str(d / "gen"), "--device",
                     "cuda"])
        torch.cuda.synchronize()
        vocode_s = time.perf_counter() - t0
        k2_vocode = fused_resblock_step.launches
        vocoded = sorted(p.name for p in (d / "gen").iterdir())
    per_forward = 72
    ok = (runs[0]["end_step"] == 2 and runs[1]["end_step"] == 4
          and runs[0]["checkpoints"] == ["do_00000002", "g_00000002"]
          and runs[1]["checkpoints"] == ["do_00000002", "do_00000004",
                                         "g_00000002", "g_00000004"]
          and all(r["validation_k2_launches"] == per_forward for r in runs)
          and k1 == 3 * 72 and k2_vocode == 2 * per_forward
          and len(vocoded) == 2 and {"inpainted.wav", "hifi_masked.wav"}
          <= set(predicted) and fold_gap <= 1e-6 and sweep["ok"])
    row = {"phase": "train_hifigan_cli", "wavs": 32, "valid_wavs": 16,
           "seconds_per_wav": 3.0, "setup_seconds": setup_s, "runs": runs,
           "g_vs_fold_waveform_gap": fold_gap, "validation_sweep": sweep,
           "predict_ea_k1_launches": k1, "predict_seconds": predict_s,
           "vocode_k2_launches": k2_vocode,
           "vocode_k2_launches_per_forward": k2_vocode // 2,
           "vocode_seconds": vocode_s, "predicted": predicted,
           "vocoded": vocoded, "ok": ok}
    emit(row)
    if not ok:
        raise AssertionError("train_hifigan CLI check failed")
    errs = phase_ida_kernel_check(torch, sweep["path"], B=GAN_B,
                                  name="gan_valid_kernel_check")
    return {**row, "kernel_check": errs}


def _sweep_check(torch, generator, wavs) -> dict:
    """The trained generator folded (K2) as the validation sweep runs it:
    one B = 16 forward on the hop-256 mels of 16 validation crops of the
    config's segment (its 173 frames), kernel path against plain path
    (f32 waveform within MAIN_ATOL), with its K2 launches; and the stage
    lengths of that forward, for `phase_ida_kernel_check`."""
    from speech_inpainting_torch.device import full_f32
    from speech_inpainting_torch.models.hifigan import Generator
    from speech_inpainting_torch.ops.mel import (VOCODER_MEL_22K,
                                                 mel_spectrogram)
    from speech_inpainting_torch.ops.resblock import fused_resblock_step
    gen = generator.fold(cls=Generator)
    audio = torch.as_tensor(wavs[:, :GAN_SEG], device="cuda")
    with torch.no_grad(), full_f32():
        mel = mel_spectrogram(audio, VOCODER_MEL_22K)
        fused_resblock_step.launches = 0
        out = gen(mel)
        torch.cuda.synchronize()
        launches = fused_resblock_step.launches
        gen.use_kernel = False
        plain = gen(mel)
    gap = float((out - plain).abs().max())
    cfg = generator.cfg
    stage_T, t = {}, mel.shape[-1]
    for i, u in enumerate(cfg.upsample_rates):
        t *= u
        stage_T[cfg.upsample_initial_channel // 2 ** (i + 1)] = t
    return {"B": mel.shape[0], "frames": mel.shape[-1],
            "k2_launches": launches, "kernel_vs_plain_max_abs": gap,
            "tolerance": MAIN_ATOL,
            "path": {"T": stage_T, "kernel_sizes": cfg.resblock_kernel_sizes,
                     "dilations": cfg.resblock_dilation_sizes},
            "ok": launches == 72 and gap <= MAIN_ATOL
            and tuple(out.shape) == (GAN_B, 1, GAN_SEG)}


# ------------------------------------------- the iSTFT-head GAN trainer

ISTFT_SEG = 8192       # the vanilla recipe's segment (configs/hifigan_v1.json)
ISTFT_LAUNCHES = 36    # K1 in one forward of the C8C8I trunk: 6 ResBlock1s
#                        of 3 steps, two launches a step


def phase_istft_gan_step_parity(torch) -> dict:
    """The GAN step with the iSTFT-head generator at full width on the card
    against the CPU: `WNISTFTGenerator` at the C8C8I geometry, width 512
    (ISTFTGeneratorConfig's defaults), drawn to carry its input
    (testing.generator_tree's carry=True), the vanilla recipe of
    configs/hifigan_v1.json, the full MPD and MSD, B = 2 × 8192, f32,
    batched_disc on; the phase's own draws of the generator, the
    discriminators and the batch. One step on the card and on the CPU, and
    in float64 on the CPU: loss_disc, loss_gen_all and mel_error rel 1e-5;
    every parameter, gradient, moment and u/v by `_gan_gaps`, with the
    elements behind a discriminator leaky-ReLU input on which the two
    float32 runs took different slopes, and whose float64 value lies
    within rounding of the kink, apart (`_kink_flips`: each flip with its
    float64 margin is printed; a flip outside rounding exempts nothing).
    The row gives the seconds of each stage."""
    from speech_inpainting_torch.models.hifigan_istft import (
        ISTFTGeneratorConfig)
    from speech_inpainting_torch.train.hifigan import make_vanilla_step
    rng = np.random.default_rng(SEED + 200)
    icfg = ISTFTGeneratorConfig()
    tcfg = _gan_cfg(CONFIGS / "hifigan_v1.json", ISTFT_SEG)
    trees = _gan_trees(torch, icfg, rng)
    batch = {"audio": _gan_audio(rng, 2, ISTFT_SEG)}
    step = make_vanilla_step(tcfg)
    t0 = time.perf_counter()
    runs, z, stage_s = {}, {}, {}
    for name, dev, f64 in (("card", "cuda", False), ("cpu", "cpu", False),
                           ("ref", "cpu", True)):
        t1 = time.perf_counter()
        state = _gan_state(torch, tcfg, trees, dev, f64=f64, icfg=icfg)
        with _d_step_preacts(torch, state) as z[name]:
            runs[name] = step(state, {"audio": batch["audio"].astype(
                np.float64)} if f64 else batch)
        stage_s[f"{name}_step"] = time.perf_counter() - t1
    (card, mc), (cpu, mp), (ref, _) = runs.values()
    mc = {k: float(v) for k, v in mc.items()}
    mp = {k: float(v) for k, v in mp.items()}
    t1 = time.perf_counter()
    kink, flips = _kink_flips(torch, cpu, z["card"], z["cpu"], z["ref"])
    stage_s["kink_flips"] = time.perf_counter() - t1
    del z
    t1 = time.perf_counter()
    gaps = _gan_gaps(_gan_tensors(torch, card), _gan_tensors(torch, cpu),
                     _gan_tensors(torch, ref), kink)
    stage_s["gate"] = time.perf_counter() - t1
    n_params = sum(p.numel() for p in card.generator.parameters())
    del card, cpu, ref, runs, kink
    rels = {k: _rel(mc[k], mp[k]) for k in mc}
    keys = ("loss_disc", "loss_gen_all", "mel_error")
    ok = max(rels[k] for k in keys) <= 1e-5 and gaps["ok"]
    row = {"phase": "istft_gan_step_parity",
           "generator": f"C8C8I width {icfg.upsample_initial_channel}",
           "generator_params_millions": n_params / 1e6,
           "config": "hifigan_v1.json", "B": 2, "samples": ISTFT_SEG,
           "dtype": "float32", "metrics_card": mc, "metrics_cpu": mp,
           "metrics_rel": rels, "card_vs_cpu": gaps,
           "kink_flips_card_vs_cpu": flips, "seconds_by_stage": stage_s,
           "seconds": time.perf_counter() - t0, "ok": ok}
    emit(row)
    if not ok:
        raise AssertionError("iSTFT GAN step parity check failed")
    return row


def phase_istft_gan_train(torch, main_setup, covered) -> dict:
    """The iSTFT-head generator's training as a user runs it, at full width
    (C8C8I, width 512; configs/hifigan_v1.json's vanilla recipe, the full
    MPD and MSD, batched_disc on, the CLI's init):
      - eight f32 steps on one batch of B = 16 × 8192 (3.0 s of audio a
        step): each step's host seconds, forced to complete by the port's
        `utils/timing.force` (the first, with cuDNN's algorithm choice,
        apart; median, min and max of steps 2-8), its CUDA-event ms beside
        it, trained audio-s per s, peak memory, the bound
        (`gan_step_bound_ms` over the iSTFT geometry); one more step under
        `utils/profiling.trace` (its Chrome trace holds the card's
        kernels); mel_error over the last three steps below the first's;
      - `train_hifigan.main --istft` on 32 synthetic 3 s wavs with a
        16-wav validation filelist, twice (2 steps and a validation sweep,
        then resumed 2 → 4 and another sweep): the sweep's folded
        `ISTFTGenerator` launches K1 36 times (one B = 16 forward), K1
        against its plain version at the sweep's tiles no earlier check
        reached, the sweep's forward kernel path against plain path;
      - the g_ it wrote, loaded into `trainable_istft_generator` and
        folded, as the vocoder of the main path's `InformedInpainter`
        (HuBERT-base + head, 100×80 codebook, B = 4 × 4 s) by
        `_path_check`: 36 K1 launches a batch, kernel path against plain
        path (atol MAIN_ATOL), card against the CPU on the short input; and
        that folded generator equal to the trained module's fold()."""
    import tempfile
    from speech_inpainting_torch.cli import train_hifigan
    from speech_inpainting_torch.convert.from_jax import (
        trainable_istft_generator)
    from speech_inpainting_torch.device import full_f32
    from speech_inpainting_torch.infer.inpaint import InformedInpainter
    from speech_inpainting_torch.models.hifigan_istft import (
        ISTFTGeneratorConfig)
    from speech_inpainting_torch.ops.mel import (VOCODER_MEL_22K,
                                                 mel_spectrogram)
    from speech_inpainting_torch.ops.resblock import fused_resblock1
    from speech_inpainting_torch.testing import synthetic_batch
    from speech_inpainting_torch.train.gan import (create_gan_state,
                                                   default_discriminators)
    from speech_inpainting_torch.train.hifigan import make_vanilla_step
    from speech_inpainting_torch.utils.profiling import trace
    from speech_inpainting_torch.utils.timing import force
    rng = np.random.default_rng(SEED + 210)
    t_start = time.perf_counter()
    icfg = ISTFTGeneratorConfig()
    tcfg = _gan_cfg(CONFIGS / "hifigan_v1.json", ISTFT_SEG)
    torch.cuda.reset_peak_memory_stats()
    gen = trainable_istft_generator(
        icfg, device="cuda", generator=torch.Generator().manual_seed(1234))
    state = create_gan_state(tcfg.gan, gen,
                             *default_discriminators(tcfg.gan, "cuda"))
    n_params = sum(p.numel() for m in (state.generator, state.mpd, state.msd)
                   for p in m.parameters())
    batch = {"audio": torch.as_tensor(_gan_audio(rng, GAN_B, ISTFT_SEG),
                                      device="cuda")}
    step = make_vanilla_step(tcfg)
    host_s, ms, metrics = [], [], []
    for _ in range(8):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        a.record()
        state, m = step(state, batch)
        b.record()
        force(m)
        host_s.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
        metrics.append({k: float(v) for k, v in m.items()})
    with tempfile.TemporaryDirectory() as prof_dir:
        with trace(prof_dir):
            force(step(state, batch)[1])
        events = json.loads((Path(prof_dir) / "trace.json").read_text())
    kernels = sum(str(e.get("cat", "")).lower() == "kernel"
                  for e in events["traceEvents"])
    med = float(np.median(host_s[1:]))
    audio_s = GAN_B * ISTFT_SEG / GAN_SR
    mel = [m["mel_error"] for m in metrics]
    finite = all(np.isfinite(v) for m in metrics for v in m.values())
    train = {"first_step_s": host_s[0], "s_per_step_median": med,
             "s_per_step_min": min(host_s[1:]),
             "s_per_step_max": max(host_s[1:]), "s_per_step": host_s,
             "event_ms_per_step": ms,
             "event_ms_per_step_median": float(np.median(ms[1:])),
             "audio_seconds_per_second": audio_s / med,
             "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
             "mel_error": mel, "trace_kernel_events": kernels,
             **gan_step_bound_ms(icfg, GAN_B, ISTFT_SEG, n_params, False)}
    train_ok = finite and max(mel[-3:]) < mel[0] and kernels > 0
    del state, step, gen, batch
    cfg, hp, gp, centroids = main_setup
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        (d / "wavs").mkdir()
        # two batches to train on (an epoch of 2 steps), one to validate
        wavs = synthetic_batch(rng, 3 * GAN_B, 3.0)[0]
        names = [f"utt{i:02d}" for i in range(3 * GAN_B)]
        for n, w in zip(names, wavs):
            _write_wav(d / "wavs" / f"{n}.wav", w, GAN_SR)
        (d / "train.txt").write_text("\n".join(names[:2 * GAN_B]) + "\n")
        (d / "valid.txt").write_text("\n".join(names[2 * GAN_B:]) + "\n")
        cmd = ["--wavs", str(d / "wavs"), "--filelist", str(d / "train.txt"),
               "--valid-filelist", str(d / "valid.txt"), "--config",
               str(CONFIGS / "hifigan_v1.json"), "--istft",
               "--checkpoint-path", str(d / "ckpt"), "--batch-size",
               str(GAN_B), "--epochs", "1", "--validation-interval", "2",
               "--device", "cuda"]
        runs = []
        for _ in range(2):
            fused_resblock1.launches = 0
            t0 = time.perf_counter()
            state = train_hifigan.main(cmd)
            torch.cuda.synchronize()
            runs.append({"seconds": time.perf_counter() - t0,
                         "end_step": state.step,
                         "validation_k1_launches": fused_resblock1.launches,
                         "checkpoints": sorted(
                             p.name for p in (d / "ckpt").iterdir())})
        sd = torch.load(d / "ckpt" / "g_00000004", map_location="cpu",
                        weights_only=True)["generator"]
    # a forward at the sweep's shapes (B = 16 crops of 8192 samples of the
    # validation wavs, 32 frames), kernel path against plain path
    served = {}
    for dev in ("cuda", "cpu"):
        g = trainable_istft_generator(state.generator.istft, device=dev)
        g.load_state_dict(sd)
        served[dev] = g.fold()
    folded = served["cuda"]
    audio = torch.as_tensor(wavs[2 * GAN_B:, :ISTFT_SEG], device="cuda")
    with torch.no_grad(), full_f32():
        sweep_mel = mel_spectrogram(audio, VOCODER_MEL_22K)
        fused_resblock1.launches = 0
        out = folded(sweep_mel)
        torch.cuda.synchronize()
        sweep_launches = fused_resblock1.launches
        fold_gap = float((out - state.generator.fold()(sweep_mel))
                         .abs().max())
        folded.use_kernel = False
        plain = folded(sweep_mel)
        folded.use_kernel = True
    sweep_gap = float((out - plain).abs().max())
    frames = sweep_mel.shape[-1]
    stage_T = {icfg.upsample_initial_channel // 2: frames * 8,
               icfg.upsample_initial_channel // 4: frames * 64}
    errs = _k1_checks(torch, _uncovered_shapes(torch, covered, (GAN_B,),
                                               stage_T),
                      "istft_valid_kernel_check", SEED + 220)
    del state
    inp = InformedInpainter(cfg, hp, None, centroids, generator=folded)
    cpu = InformedInpainter(cfg, hp, None, centroids, device="cpu",
                            generator=served["cpu"])
    check = _path_check(torch, "istft_trained_inpainter", inp, cpu,
                        synthetic_batch(rng, 4, 4.0), ISTFT_LAUNCHES)
    del inp, cpu, served, folded
    ok = (train_ok and runs[0]["end_step"] == 2 and runs[1]["end_step"] == 4
          and runs[0]["checkpoints"] == ["do_00000002", "g_00000002"]
          and runs[1]["checkpoints"] == ["do_00000002", "do_00000004",
                                         "g_00000002", "g_00000004"]
          and all(r["validation_k1_launches"] == ISTFT_LAUNCHES
                  for r in runs)
          and sweep_launches == ISTFT_LAUNCHES and sweep_gap <= MAIN_ATOL
          and fold_gap <= 1e-6 and check["ok"])
    row = {"phase": "istft_gan_train",
           "generator": f"C8C8I width {icfg.upsample_initial_channel}",
           "config": "hifigan_v1.json", "recipe": "vanilla", "B": GAN_B,
           "samples": ISTFT_SEG, "audio_seconds_per_step": audio_s,
           "train": train, "cli_runs": runs,
           "validation_sweep": {"B": GAN_B, "frames": frames,
                                "k1_launches": sweep_launches,
                                "kernel_vs_plain_max_abs": sweep_gap,
                                "tolerance": MAIN_ATOL,
                                "g_file_vs_fold_max_abs": fold_gap,
                                "kernel_checks": len(errs)},
           "inpainter_k1_launches": check["launches"],
           "seconds": time.perf_counter() - t_start, "ok": ok}
    emit(row)
    if not ok:
        raise AssertionError("iSTFT GAN training check failed")
    return {**row, "path": {"T": stage_T,
                            "kernel_sizes": icfg.resblock_kernel_sizes,
                            "dilations": icfg.resblock_dilation_sizes},
            "kernel_check_rows": errs}


F0VQ_CONFIG = CONFIGS / "f0_vqvae.json"
F0VQ_SILENT = 4        # all-unvoiced clips in the parity batch (of 16)
# the parity run's candidate generator: its first draw takes the same
# frame of two silent clips (flat rows 24 and 37, frame 11 of clips 1 and
# 2, whose latents are equal), so the first step restarts the repeat
F0VQ_PARITY_GEN = 4
F0VQ_STEPS = 300       # f0vq_train's steps
PREP_UTTS = 20         # the prep CLI's corpus: 20 wavs of 2 s at 22.05 kHz


def _f0vq_configs():
    """configs/f0_vqvae.json as train_f0vq reads it: (the dict, the
    F0VQConfig)."""
    from speech_inpainting_torch.models.codegen import FoVQVAEConfig
    from speech_inpainting_torch.train.f0vq import F0VQConfig
    h = json.loads(F0VQ_CONFIG.read_text())
    return h, F0VQConfig(model=FoVQVAEConfig.from_dict(h),
                         learning_rate=h["learning_rate"],
                         adam_b1=h["adam_b1"], adam_b2=h["adam_b2"],
                         lr_decay=h["lr_decay"],
                         lambda_commit=h["lambda_commit"])


def _f0_corpus(torch, n=64, seconds=3.0) -> tuple:
    """(F0DatasetTPU on the card over `n` synthetic 16 kHz utterances of
    `seconds`, written to a temporary directory, at f0_vqvae.json's
    segment; the seconds it took to track them)."""
    import tempfile
    from speech_inpainting_torch.data.code_dataset import F0DatasetTPU
    from speech_inpainting_torch.testing import synthetic_utterance
    h, _ = _f0vq_configs()
    rng = np.random.default_rng(SEED + 200)
    with tempfile.TemporaryDirectory() as tmp:
        files = []
        for i in range(n):
            files.append(Path(tmp) / f"s{i % 4}_{i:03d}.wav")
            _write_wav(files[-1], synthetic_utterance(rng, seconds), 16000)
        t0 = time.perf_counter()
        ds = F0DatasetTPU(files, segment_size=h["segment_size"],
                          device="cuda")
        return ds, time.perf_counter() - t0


def _empty_vq(cfg) -> dict:
    return {"vq": {f"level_{i}": {
        "k": np.zeros((cfg.l_bins, cfg.emb_width), np.float32),
        "k_sum": np.zeros((cfg.l_bins, cfg.emb_width), np.float32),
        "k_elem": np.zeros(cfg.l_bins, np.float32),
        "initted": np.zeros((), bool)} for i in range(cfg.levels)}}


def _f0vq_tensors(state) -> dict:
    """Every parameter, both AdamW moments and the codebook buffers of a
    F0VQTrainState, as "kind name" → float64 CPU tensors."""
    out = {}
    for n, p in state.model.named_parameters():
        st = state.optimizer.state[p]
        out[f"param {n}"] = p.detach().double().cpu()
        out[f"mu {n}"] = st["exp_avg"].double().cpu()
        out[f"nu {n}"] = st["exp_avg_sq"].double().cpu()
    for n, b in state.model.named_buffers():
        if b.is_floating_point():
            out[f"vq {n}"] = b.double().cpu()
    return out


def phase_f0vq_step_parity(torch, ds) -> dict:
    """Three steps of the pitch quantizer's trainer at full width
    (configs/f0_vqvae.json: 1 → 32 channels, 4 strided stages, a 20 × 128
    codebook; B = 16 × 208 f0 frames of `_f0_corpus`, F0VQ_SILENT of them
    all unvoiced, as silent clips are, so that their latents repeat) from
    one seeded tree and an uninitialised codebook: on the card, on the CPU
    in float32 and in float64, each with the same CPU generator's
    candidates (F0VQ_PARITY_GEN, whose first draw repeats a silent frame).
    Gates: labels card vs CPU equal at every step; the first step
    initialises the codebook and restarts codes; losses rel 1e-5; every
    parameter, AdamW moment and codebook buffer by testing.parity_gate
    (card against the CPU's float32 step, the float64 step beside it; a
    parameter whose gradient is zero up to rounding held to AdamW's noise
    bound)."""
    from speech_inpainting_torch.convert.from_jax import trainable_fo_vqvae
    from speech_inpainting_torch.testing import (ADAMW_NOISE, NOISE,
                                                 fo_vqvae_tree, parity_gate,
                                                 zero_up_to_rounding)
    from speech_inpainting_torch.train.f0vq import (create_f0vq_state,
                                                    make_f0vq_step)
    h, tcfg = _f0vq_configs()
    cfg = tcfg.model
    params, _ = fo_vqvae_tree(cfg, np.random.default_rng(SEED + 201))
    f0 = next(ds.batches(h["batch_size"], epoch=0, seed=SEED))["f0"]
    f0[:F0VQ_SILENT] = 0.0
    t0 = time.perf_counter()
    runs = {}
    for name, device, dtype in (("card", "cuda", torch.float32),
                                ("cpu", "cpu", torch.float32),
                                ("f64", "cpu", torch.float64)):
        model = trainable_fo_vqvae(cfg, params, _empty_vq(cfg),
                                   device=device).to(dtype)
        labels = []
        model.vq.level_0.register_forward_hook(
            lambda m, a, out, into=labels: into.append(out[0].cpu()))
        state = create_f0vq_state(tcfg, model)
        step = make_f0vq_step(tcfg, device=device)
        gen = torch.Generator().manual_seed(F0VQ_PARITY_GEN)
        batch = {"f0": f0.astype(np.float64 if dtype == torch.float64
                                 else np.float32)}
        metrics, usage = [], None
        for i in range(3):
            state, m = step(state, batch, gen)
            metrics.append({k: float(v) for k, v in m.items()})
            if i == 0:
                usage = int(m["usage"])
        runs[name] = dict(state=state, labels=labels, metrics=metrics,
                          usage_after_first=usage,
                          initted=bool(model.vq.level_0.initted))
    torch.cuda.synchronize()
    card, cpu, f64 = (_f0vq_tensors(runs[k]["state"])
                      for k in ("card", "cpu", "f64"))
    mu = [k for k in cpu if k.startswith("mu ")]
    zero = zero_up_to_rounding({k: cpu[k] for k in mu},
                               {k: f64[k] for k in mu})
    zero = {"param " + k[3:]: m for k, m in zero.items()}
    rep = parity_gate(card, cpu, f64, exempt=zero,
                      bound=ADAMW_NOISE * tcfg.learning_rate)
    labels_equal = [bool(torch.equal(a, b)) for a, b in
                    zip(runs["card"]["labels"], runs["cpu"]["labels"])]
    loss_rel = max(_rel(a[k], b[k])
                   for a, b in zip(runs["card"]["metrics"],
                                   runs["cpu"]["metrics"])
                   for k in ("loss", "recon", "commit"))
    restarted = cfg.l_bins - runs["card"]["usage_after_first"]
    ok = (len(labels_equal) == 3 and all(labels_equal)
          and runs["card"]["initted"] and restarted > 0
          and loss_rel <= 1e-5 and rep["ok"]
          and runs["card"]["state"].step == 3)
    row = {"phase": "f0vq_step_parity", "config": "f0_vqvae.json",
           "batch": list(f0.shape), "silent_clips": F0VQ_SILENT,
           "labels_equal_each_step": labels_equal,
           "codes_restarted_on_first_step": restarted,
           "loss_card": [m["loss"] for m in runs["card"]["metrics"]],
           "loss_cpu": [m["loss"] for m in runs["cpu"]["metrics"]],
           "loss_f64": [m["loss"] for m in runs["f64"]["metrics"]],
           "losses_max_rel": loss_rel, "losses_rtol": 1e-5,
           "gate_outside": rep["outside"], "gate_exempt": rep["exempt"],
           "share_max": rep["share_max"], "excess_max": rep["excess_max"],
           "small_excess_max": rep["small_excess_max"],
           "limits": {"share": NOISE.share, "excess": NOISE.excess,
                      "small_excess": NOISE.small_excess},
           "f64_tensors": len(rep["f64"]), "failed": rep["failed"],
           "seconds": time.perf_counter() - t0, "ok": ok}
    emit(row)
    if not ok:
        raise AssertionError("f0-VQ-VAE step parity failed")
    return row


def f0vq_forward_flops(torch, model, f0) -> float:
    """FLOPs (2 per multiply-add) of one FoVQVAE forward of `f0`: its
    convolutions, counted by forward hooks, and the VQ's distance GEMM."""
    total = 0.0

    def conv(m, args, out):
        nonlocal total
        if isinstance(m, torch.nn.ConvTranspose1d):
            total += 2.0 * args[0].numel() * m.out_channels * m.kernel_size[0]
        else:
            total += 2.0 * out.numel() * m.in_channels * m.kernel_size[0]

    hooks = [m.register_forward_hook(conv) for m in model.modules()
             if isinstance(m, (torch.nn.Conv1d, torch.nn.ConvTranspose1d))]
    with torch.no_grad():
        model(f0)
    for hook in hooks:
        hook.remove()
    cfg = model.cfg
    rows = f0.shape[0] * f0.shape[-1] // cfg.encoder.total_stride
    return total + 2.0 * rows * cfg.l_bins * cfg.emb_width


def phase_f0vq_train(torch, ds, corpus_s) -> dict:
    """The pitch quantizer's trainer at full width (configs/f0_vqvae.json,
    B = 16 × 208 f0 frames) over `_f0_corpus`'s 64 utterances, from a fresh
    init drawn from SEED with an uninitialised codebook: F0VQ_STEPS steps,
    each between two CUDA events (ms per step, median and range after 5,
    f0 frames per second, peak memory, the bound), one step profiled (the
    busy share), the host's wall time to enqueue a forward and a forward
    and backward, the EMA update timed alone. Gates: losses finite, recon
    falling (the mean of the last 10 steps under the first 10's), used_curr
    above 1 over the last 10 steps."""
    from speech_inpainting_torch.convert.from_jax import trainable_fo_vqvae
    from speech_inpainting_torch.device import full_f32
    from speech_inpainting_torch.train.f0vq import (create_f0vq_state,
                                                    make_f0vq_step)
    h, tcfg = _f0vq_configs()
    B = h["batch_size"]
    model = trainable_fo_vqvae(tcfg.model, seed=SEED, device="cuda")
    state = create_f0vq_state(tcfg, model)
    step = make_f0vq_step(tcfg, device="cuda")
    gen = torch.Generator().manual_seed(SEED + 2)
    batches, epoch = [], 0
    while len(batches) < F0VQ_STEPS:
        batches += [{"f0": torch.as_tensor(b["f0"], device="cuda")}
                    for b in ds.batches(B, epoch=epoch, seed=SEED)]
        epoch += 1
    batches = batches[:F0VQ_STEPS]
    flops = 3 * f0vq_forward_flops(torch, model, batches[0]["f0"])
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in batches]
    metrics = []
    t0 = time.perf_counter()
    for (a, b), batch in zip(events, batches):
        a.record()
        state, m = step(state, batch, gen)
        b.record()
        metrics.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    ms = [a.elapsed_time(b) for a, b in events][5:]
    recon = [float(m["recon"]) for m in metrics]
    loss = [float(m["loss"]) for m in metrics]
    used = [int(m["used_curr"]) for m in metrics]
    prof = _profile_step(torch, lambda s, b: step(s, b, gen), state,
                         batches[0])
    # the host's share: wall time to enqueue the forward alone, and the
    # forward and backward (no optimizer), per call, without a sync
    host_ms = {}
    for part in ("forward", "forward_backward"):
        ts = []
        for b in batches[:30]:
            t1 = time.perf_counter()
            with full_f32():
                out, commits, _ = model(b["f0"], train=True, generator=gen)
                if part == "forward_backward":
                    model.zero_grad(set_to_none=True)
                    (((out - b["f0"]) ** 2).mean()
                     + tcfg.lambda_commit * sum(commits)).backward()
            ts.append((time.perf_counter() - t1) * 1e3)
        torch.cuda.synchronize()
        host_ms[part] = float(np.median(ts))
    q = model.vq.level_0
    flat = torch.randn(B * h["segment_size"] // 80 // 16, q.emb_width,
                       device="cuda")
    labels, _ = q.quantise(flat)
    ema_ms = cuda_ms(lambda: q._update_k(flat, labels, flat[:q.k_bins]), 50)
    med = float(np.median(ms))
    frames = B * h["segment_size"] // 80
    bound_ops = flops / PEAK_FLOPS["float32"] * 1e3
    # parameters, gradients and both moments read and written once, the
    # batch read once: the bytes a step must move at the least
    bound_bytes = (n_params * 4 * 7 + frames * 4) / PEAK_BYTES * 1e3
    ok = (all(math.isfinite(v) for v in loss)
          and np.mean(recon[-10:]) < np.mean(recon[:10])
          and min(used[-10:]) > 1)
    row = {"phase": "f0vq_train", "config": "f0_vqvae.json", "batch": B,
           "f0_frames_per_step": frames, "steps": F0VQ_STEPS,
           "parameters": n_params, "corpus_tracking_s": corpus_s,
           "ms_per_step_median": med, "ms_per_step_min": min(ms),
           "ms_per_step_max": max(ms),
           "f0_frames_per_s": frames / (med / 1e3),
           "wall_s": wall, "peak_memory_gb": peak / 1e9,
           "step_gflop": flops / 1e9,
           "bound_ms": max(bound_ops, bound_bytes),
           "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
           "ema_update_ms": ema_ms,
           "host_enqueue_ms_median": host_ms,
           "recon_first10": float(np.mean(recon[:10])),
           "recon_last10": float(np.mean(recon[-10:])),
           "used_curr_first": used[0], "used_curr_last10_min":
               min(used[-10:]), "used_curr_last": used[-1],
           "usage_last": float(metrics[-1]["usage"]),
           "entropy_last": float(metrics[-1]["entropy"]),
           "profile": prof, "ok": ok}
    emit(row)
    if not ok:
        raise AssertionError("f0-VQ-VAE training check failed")
    return row


def phase_prep_and_train_f0vq_cli(torch, ida, d: Path) -> dict:
    """The I_da preparation a user runs before `train_da`, on the card, on
    files written to a temporary directory: PREP_UTTS synthetic 2 s
    22.05 kHz wavs of three speakers with quiet edges, an HF-layout
    HuBERT-base directory of `ida_main`'s weights.
    `prep preprocess` (16 kHz, trimmed, padded) → `manifest` → `features`
    (layer 6) → `kmeans_cli fit` (k = 100) → `quantize` → `parse-codes` →
    `f0-stats`; `train_f0vq` on the train manifest with
    configs/f0_vqvae.json, twice (2 steps, then resumed 2 → 4); one
    CodeDataset batch (B = 4) from the manifests; then one I_da utterance
    (`ida_main`'s 4 s input and trees) through `IdaInpainter` with the
    pitch quantizer from the `train_f0vq` directory
    (convert/ida_torch.py:load_f0_quantizer): K2 launches, kernel path vs
    plain path. The units of five files again on the CPU: equal to the
    card's wherever the nearest centroid wins by more than HuBERT's card
    vs CPU tolerance could move it (the frames within that margin are
    counted). Each step's wall time. Its files stay in `d` for
    `train_da_cli`."""
    from speech_inpainting_torch.cli import kmeans_cli, prep, train_f0vq
    from speech_inpainting_torch.convert.from_jax import codegen_from_jax
    from speech_inpainting_torch.convert.ida_torch import load_f0_quantizer
    from speech_inpainting_torch.data.code_dataset import (CodeDataset,
                                                           CodeDatasetConfig)
    from speech_inpainting_torch.data.manifests import (parse_manifest,
                                                        read_units_file)
    from speech_inpainting_torch.infer.ida_inpaint import IdaInpainter
    from speech_inpainting_torch.models.hubert import HubertConfig
    from speech_inpainting_torch.ops.resblock import (fused_resblock1,
                                                      fused_resblock_step)
    from speech_inpainting_torch.testing import (synthetic_utterance,
                                                 write_hf_hubert)
    setup = ida["setup"]
    rng = np.random.default_rng(SEED + 210)
    seconds = {}

    def timed(name, main, argv):
        t0 = time.perf_counter()
        out = main([str(a) for a in argv])
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return out

    (d / "raw").mkdir()
    for i in range(PREP_UTTS):
        quiet = rng.standard_normal(6615).astype(np.float32) * 1e-4
        wav = np.concatenate([quiet, synthetic_utterance(rng, 2.0, 22050),
                              quiet])
        _write_wav(d / "raw" / f"p{225 + i % 3}_{i:03d}.wav", wav, 22050)
    t0 = time.perf_counter()
    write_hf_hubert(d / "hubert", setup["hp"], HubertConfig.base())
    seconds["write_hf_hubert"] = time.perf_counter() - t0
    tsv = d / "m" / "train.tsv"
    timed("preprocess", prep.main,
          ["preprocess", "--root", d / "raw", "--out", d / "wavs"])
    timed("manifest", prep.main,
          ["manifest", "--root", d / "wavs", "--dest", d / "m"])
    hub = ["--hubert", d / "hubert", "--layer", IDA_TAP]
    timed("features", prep.main, ["features", "--manifest", tsv, *hub,
                                  "--out", d / "feats" / "train.npy",
                                  "--device", "cuda"])
    timed("kmeans_fit", kmeans_cli.main,
          ["fit", "--features", d / "feats" / "train.npy", "--k", 100,
           "--iters", 20, "--n-init", 1, "--out", d / "km.npy",
           "--device", "cuda"])
    timed("quantize", prep.main, ["quantize", "--manifest", tsv, *hub,
                                  "--kmeans", d / "km.npy", "--out",
                                  d / "units.txt", "--device", "cuda"])
    lines = tsv.read_text().splitlines()
    (d / "m" / "five.tsv").write_text("\n".join(lines[:6]) + "\n")
    timed("quantize_cpu_five_files", prep.main,
          ["quantize", "--manifest", d / "m" / "five.tsv", *hub,
           "--kmeans", d / "km.npy", "--out", d / "units_cpu.txt",
           "--device", "cpu"])
    timed("parse_codes", prep.main,
          ["parse-codes", "--manifest", tsv, "--units", d / "units.txt",
           "--outdir", d / "codes"])
    timed("f0_stats", prep.main,
          ["f0-stats", "--manifest", d / "codes" / "train.txt", "--out",
           d / "f0_stats.json", "--device", "cuda"])
    train = ["--config", F0VQ_CONFIG, "--train-manifest",
             d / "codes" / "train.txt", "--checkpoint-path", d / "f0vq",
             "--epochs", 2, "--device", "cuda"]
    first = timed("train_f0vq", train_f0vq.main, train)
    first_step = first.step
    del first
    second = timed("train_f0vq_resumed", train_f0vq.main, train)
    checkpoints = sorted(p.name for p in (d / "f0vq").iterdir())

    # card vs CPU units, where the margin exceeds what HuBERT's card vs
    # CPU tolerance can move
    card_units, cpu_units = (dict(read_units_file(d / n)) for n in
                             ("units.txt", "units_cpu.txt"))
    feats = np.load(d / "feats" / "train.npy")
    cents = np.load(d / "km.npy")
    offsets, o = {}, 0
    for line in lines[1:]:
        name = Path(line.split("\t")[0]).stem
        offsets[name] = o
        o += len(card_units[name])
    f64, c64 = feats.astype(np.float64), cents.astype(np.float64)
    dist = ((f64 ** 2).sum(1)[:, None] - 2 * f64 @ c64.T
            + (c64 ** 2).sum(1)[None])
    order = np.argsort(dist, axis=1)[:, :2]
    d1 = np.take_along_axis(dist, order, 1)
    reach = 2 * np.linalg.norm(cents[order[:, 0]] - cents[order[:, 1]],
                               axis=1) * np.sqrt(feats.shape[1]) * \
        HUBERT_ATOL
    within = (d1[:, 1] - d1[:, 0]) <= reach
    compared = mismatched = mismatched_outside = 0
    for name, units in cpu_units.items():
        sl = slice(offsets[name], offsets[name] + len(units))
        diff = card_units[name] != units
        compared += len(units)
        mismatched += int(diff.sum())
        mismatched_outside += int((diff & ~within[sl]).sum())

    files, codes = parse_manifest(d / "codes" / "train.txt")
    ida_cfg = json.loads(IDA_CONFIG.read_text())
    t0 = time.perf_counter()
    cds = CodeDataset(files, codes, CodeDatasetConfig(
        segment_size=ida_cfg["segment_size"],
        embedding_dim=ida_cfg["embedding_dim"]), device="cuda")
    batch = next(cds.batches(4, epoch=0, seed=SEED))
    seconds["code_dataset"] = time.perf_counter() - t0
    seg = ida_cfg["segment_size"]
    want_shapes = {"audio": (4, 1, seg), "code": (4, seg // 320),
                   "f0": (4, 1, seg // 80),
                   "mel_loss": (4, 80, seg // 256),
                   "emb": (4, ida_cfg["embedding_dim"]),
                   "spkr": (4, 1)}
    shapes = {k: tuple(v.shape) for k, v in batch.items()}
    dtypes_ok = (batch["code"].dtype == np.int32
                 and batch["spkr"].dtype == np.int32
                 and all(batch[k].dtype == np.float32 for k in
                         ("audio", "f0", "mel_loss", "emb")))
    batch_finite = all(np.isfinite(v).all() for v in batch.values())

    t0 = time.perf_counter()
    codegen = load_f0_quantizer(d / "f0vq", codegen_from_jax(
        setup["cfg"], setup["params"], setup["vq"], device="cuda"))
    trained_k_equal = bool(torch.equal(
        codegen.fo_vqvae.vq.level_0.k, second.model.vq.level_0.k))
    inp = IdaInpainter(setup["cfg"], None, None, HubertConfig.base(),
                       setup["hp"], setup["centroids"],
                       tap_layer=IDA_TAP, codegen=codegen,
                       device="cuda")
    seconds["load_inpainter"] = time.perf_counter() - t0
    fused_resblock_step.launches = fused_resblock1.launches = 0
    t0 = time.perf_counter()
    out = inp(setup["utts"][0], IDA_MASK, emb=setup["emb"])
    torch.cuda.synchronize()
    seconds["ida_utterance"] = time.perf_counter() - t0
    launches, k1 = fused_resblock_step.launches, fused_resblock1.launches
    inp.codegen.generator.use_kernel = False
    plain = inp(setup["utts"][0], IDA_MASK, emb=setup["emb"])
    inp.codegen.generator.use_kernel = True
    diff = max((out[k] - plain[k]).abs().max().item()
               for k in ("audio_gen", "audio_inpainted"))
    finite = all(bool(torch.isfinite(v.float()).all())
                 for k, v in out.items() if k != "rtf")
    same_shapes = (len(setup["utts"][0]) == IDA_SECONDS * 16000
                   and launches == ida["launches"])
    ok = (first_step == 2 and second.step == 4
          and checkpoints == ["g_00000002", "g_00000004"]
          and mismatched_outside == 0 and compared > 0
          and shapes == want_shapes and dtypes_ok and batch_finite
          and trained_k_equal and launches == ida["launches"]
          and k1 == 0 and diff <= MAIN_ATOL and finite)
    row = {"phase": "prep_and_train_f0vq_cli", "utterances": PREP_UTTS,
           "seconds": seconds, "train_f0vq_steps": [first_step, second.step],
           "checkpoints": checkpoints,
           "units_compared_card_vs_cpu": compared,
           "units_different": mismatched,
           "units_different_outside_margin": mismatched_outside,
           "frames_within_margin": int(within.sum()),
           "frames": int(len(within)),
           "code_dataset_shapes": shapes, "code_dataset_dtypes_ok": dtypes_ok,
           "trained_codebook_loaded": trained_k_equal,
           "k2_launches": launches, "k1_launches": k1,
           "k2_shapes": "those of ida_kernel_check (the same 4 s input, "
                        "generator and B = 1)" if same_shapes else "other",
           "kernel_vs_plain_max_abs": diff, "tolerance": MAIN_ATOL,
           "finite": finite, "ok": ok}
    emit(row)
    if not ok:
        raise AssertionError("prep / train_f0vq CLI check failed")
    return row


DA_SEG = 8960         # configs/da_hubert100_lut.json's segment_size
DA_B = 16             # its batch_size
DA_SR = 16000
DA_HOP = 320          # its code_hop_size: one unit per 320 samples
# the joint regime's parity run: B = 2 items of DA_JOINT_T code samples
# (256 encoder frames each: 512 rows), the two items equal, so that row i
# and row i + 256 are twins; the CPU generator's seed whose first draw of
# the codebook's 6 rows takes a twin pair, so that the first step restarts
# the code that lost its twin (the other code of the pair takes ~85 other
# rows and moves off the twins' frame: no tie with the restarted code)
DA_JOINT_T = 1024
DA_JOINT_SEED = 43


def _da_config(h: dict, **gan):
    """The DATrainConfig that the train_da CLI builds from the config dict
    `h` (batched_disc, the frozen pitch quantizer, lambda_commit_code, the
    loss mel from fmax_for_loss), `gan`'s settings over its GANConfig."""
    from speech_inpainting_torch.models.codegen import CodeGeneratorConfig
    from speech_inpainting_torch.ops.mel import MelConfig
    from speech_inpainting_torch.train.da import DATrainConfig
    from speech_inpainting_torch.train.gan import GANConfig
    mel = MelConfig(sampling_rate=h.get("sampling_rate", 16000),
                    n_fft=h.get("n_fft", 1024), num_mels=h.get("num_mels", 80),
                    hop_size=h.get("hop_size", 256),
                    win_size=h.get("win_size", 1024), fmin=h.get("fmin", 0),
                    fmax=h.get("fmax_for_loss"))
    gan = {"batched_disc": True, "frozen_g_paths": ("fo_vqvae",),
           "lambda_commit": h.get("lambda_commit_code", 0) or 0, **gan}
    return DATrainConfig(codegen=CodeGeneratorConfig.from_dict(h),
                         gan=GANConfig(**gan), mel_loss=mel,
                         segment_size=h.get("segment_size", DA_SEG))


def _da_batch(rng, cfg, B, seg) -> dict:
    """A CodeDataset-like batch of B crops of `seg` samples: synthetic 16 kHz
    speech, random units, a z-normalised f0 series with every fifth frame
    unvoiced (zero), random d-vectors of the config's width."""
    from speech_inpainting_torch.testing import synthetic_utterance
    audio = np.stack([synthetic_utterance(rng, seg / DA_SR + 0.01)[:seg]
                      for _ in range(B)])[:, None]
    f0 = rng.standard_normal((B, 1, seg // 80)).astype(np.float32)
    f0[:, :, ::5] = 0.0
    return {"code": rng.integers(0, cfg.num_embeddings, (B, seg // DA_HOP)
                                 ).astype(np.int32),
            "f0": f0, "emb": rng.standard_normal(
                (B, cfg.embedding_dim)).astype(np.float32),
            "audio": audio.astype(np.float32)}


def _f64_batch(batch: dict) -> dict:
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v
            for k, v in batch.items()}


def _da_trees(torch, cfg, rng, periods=(2, 3, 5, 7, 11), scales=3
              ) -> tuple:
    """One seeded tree of the three modules: the CodeGenerator's params and
    `vq` collection (testing.codegen_tree: a generator that carries the
    signal, N(0, 1) tables and codebooks), the discriminators of `periods`
    and `scales` at the port's init."""
    from speech_inpainting_torch.convert.from_jax import (mpd_from_jax,
                                                          mpd_tree,
                                                          msd_from_jax,
                                                          msd_tree,
                                                          spectral_tree)
    from speech_inpainting_torch.testing import codegen_tree
    params, vq = codegen_tree(cfg, rng)
    seed = int(rng.integers(1 << 30))
    mpd = mpd_from_jax(periods=periods, device="cpu",
                       generator=torch.Generator().manual_seed(seed))
    msd = msd_from_jax(scales=scales, device="cpu",
                       generator=torch.Generator().manual_seed(seed + 1))
    return params, vq, mpd_tree(mpd), msd_tree(msd), spectral_tree(msd)


def _da_state(torch, dcfg, trees, device, f64=False, seed=None,
              periods=(2, 3, 5, 7, 11), scales=3):
    """A GANTrainState on `device` over a WNCodeGenerator from the trees
    (create_da_state's, with its candidates' generator, where `seed` is
    given), the discriminators of `periods` and `scales`; f64 computes and
    stores everything in float64."""
    from speech_inpainting_torch.convert.from_jax import (mpd_from_jax,
                                                          msd_from_jax,
                                                          trainable_codegen)
    from speech_inpainting_torch.train.da import create_da_state
    from speech_inpainting_torch.train.gan import create_gan_state
    params, vq, mp, mv, spec = trees
    mods = (trainable_codegen(dcfg.codegen, params, vq, device=device),
            mpd_from_jax(mp, periods, device=device),
            msd_from_jax(mv, spec, scales, device=device))
    if f64:
        for m in mods:
            m.double()
            for c in m.modules():
                if hasattr(c, "dtype"):
                    c.dtype = torch.float64
    if seed is not None:
        return create_da_state(dcfg, *mods, seed=seed)
    return create_gan_state(dcfg.gan, *mods)


def _da_tensors(torch, state) -> dict:
    """_gan_tensors and the generator's codebook buffers ("vq")."""
    out = _gan_tensors(torch, state)
    out.update({f"vq generator.{n}": b.double().cpu()
                for n, b in state.generator.named_buffers()
                if b.is_floating_point()})
    return out


def _da_snapshot(torch, state) -> dict:
    """Copies, where they lie, of every parameter, AdamW moment and
    codebook buffer of a state, and its optimizers' counts."""
    out = {"counts": [s["step"] for o in (state.g_opt, state.d_opt)
                      for s in o.state.values()]}
    for mname in ("generator", "mpd", "msd"):
        module = getattr(state, mname)
        opt = state.g_opt if mname == "generator" else state.d_opt
        for n, p in module.named_parameters():
            out[f"param {mname}.{n}"] = p.detach().clone()
            for key in ("exp_avg", "exp_avg_sq"):
                if key in opt.state.get(p, {}):
                    out[f"{key} {mname}.{n}"] = opt.state[p][key].clone()
    out.update({f"vq {n}": b.clone()
                for n, b in state.generator.named_buffers()})
    return out


def _same(torch, a: dict, b: dict) -> bool:
    """Two `_da_snapshot`s bit-equal."""
    return a.keys() == b.keys() and all(
        a[k] == b[k] if k == "counts" else torch.equal(a[k], b[k])
        for k in a)


def phase_da_step_parity(torch) -> dict:
    """The unit HiFi-GAN trainer's step on the card against the CPU, in
    both regimes.

    Decoder-only at full width: configs/da_hubert100_lut.json (V1 at 512
    channels, 320× over five stages, the f0-VQ-VAE of configs/f0_vqvae.json
    frozen), the full MPD and MSD, batched_disc, f32, B = 2 × 8960 samples,
    one seeded tree (`_da_trees`): one step on the card, on the CPU and in
    float64 on the CPU; losses rel 1e-5, every parameter, gradient, moment
    and u/v by `_gan_gaps`; the pitch quantizer's parameters and buffers
    bit-unchanged and out of the optimizer, the unit and pitch tables and
    the generator moved.

    Joint, at `content_vq`'s geometry (no full-width content-VQ config is
    in the repository), B = 2 × DA_JOINT_T samples, skip_nonfinite, the
    discriminators cut to one period and one scale (full width, as the
    CPU tests cut them: the joint regime adds nothing to them): three
    steps from an uninitialised codebook on the card, on the CPU and in
    float64, each with the candidates of a CPU generator seeded
    DA_JOINT_SEED; labels card vs CPU equal at every step, the first step
    initialising the codebook and restarting a code, losses rel 1e-5,
    every tensor and codebook buffer by `_gan_gaps`. Then on the card a NaN
    batch (parameters, moments, codebook buffers and counts bit-equal, one
    skip counted), and a g_/do_ round trip into a state seeded otherwise
    (its step, codebook and candidates' generator restored)."""
    import tempfile
    from speech_inpainting_torch.train.da import make_da_step
    from speech_inpainting_torch.utils.checkpoints import (
        Checkpointer, restore_gan_checkpoint, save_gan_checkpoint)
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 220)
    dcfg = _da_config(json.loads(IDA_CONFIG.read_text()))
    trees = _da_trees(torch, dcfg.codegen, rng)
    batch = _da_batch(rng, dcfg.codegen, 2, DA_SEG)
    step = make_da_step(dcfg)
    card = _da_state(torch, dcfg, trees, "cuda")
    frozen = {k: v.clone() for k, v in
              card.generator.fo_vqvae.state_dict().items()}
    start = {n: p.detach().clone()
             for n, p in card.generator.named_parameters()}
    card, mc = step(card, batch)
    cpu, mp = step(_da_state(torch, dcfg, trees, "cpu"), batch)
    ref, _ = step(_da_state(torch, dcfg, trees, "cpu", f64=True),
                  _f64_batch(batch))
    gaps = _gan_gaps(_gan_tensors(torch, card), _gan_tensors(torch, cpu),
                     _gan_tensors(torch, ref))
    del cpu, ref
    rels = {k: _rel(float(mc[k]), float(mp[k]))
            for k in ("loss_disc", "loss_gen_all", "mel_error")}
    frozen_equal = all(torch.equal(v, frozen[k]) for k, v in
                       card.generator.fo_vqvae.state_dict().items())
    frozen_out = not any(p in card.g_opt.state
                         for p in card.generator.fo_vqvae.parameters())
    moved = {part: any(not torch.equal(p.detach(), start[n])
                       for n, p in card.generator.named_parameters()
                       if n.startswith(part + "."))
             for part in ("emb_c", "emb_p", "generator")}
    decoder = {"metrics_card": {k: float(v) for k, v in mc.items()},
               "metrics_rel": rels, "card_vs_cpu": gaps,
               "fo_vqvae_bit_unchanged": frozen_equal,
               "fo_vqvae_out_of_optimizer": frozen_out, "moved": moved,
               "seconds": time.perf_counter() - t0}
    del card
    ok = (max(rels.values()) <= 1e-5 and gaps["ok"] and frozen_equal
          and frozen_out and all(moved.values()))

    # ---- the joint regime
    t1 = time.perf_counter()
    jcfg = _da_config(dict(CONTENT_VQ, segment_size=DA_JOINT_T),
                      skip_nonfinite=3)
    cv = jcfg.codegen
    cut = {"periods": (2,), "scales": 1}
    params, vq, *discs = _da_trees(torch, cv, rng, **cut)
    vq["code_vq"] = {"level_0": {
        "k": np.zeros((cv.code_vq_bins, cv.code_vq_width), np.float32),
        "k_sum": np.zeros((cv.code_vq_bins, cv.code_vq_width), np.float32),
        "k_elem": np.zeros(cv.code_vq_bins, np.float32),
        "initted": np.zeros((), bool)}}
    jtrees = (params, vq, *discs)
    from speech_inpainting_torch.testing import synthetic_utterance
    jbatches = []
    for _ in range(4):
        code = 0.5 * synthetic_utterance(rng, DA_JOINT_T / DA_SR + 0.01)[
            :DA_JOINT_T]
        audio = np.stack([synthetic_utterance(rng, DA_JOINT_T / DA_SR
                                              + 0.01)[:DA_JOINT_T]
                          for _ in range(2)])
        jbatches.append({"code": np.stack([code, code])[:, None].astype(
            np.float32), "audio": audio[:, None].astype(np.float32)})
    jbatches[3]["code"][0, 0, 100] = np.nan
    jstep = make_da_step(jcfg)
    runs = {}
    for name, device, f64 in (("card", "cuda", False), ("cpu", "cpu", False),
                              ("f64", "cpu", True)):
        state = _da_state(torch, jcfg, jtrees, device, f64=f64,
                          seed=DA_JOINT_SEED, **cut)
        labels = []
        state.generator.code_vq.level_0.register_forward_hook(
            lambda m, a, out, into=labels: into.append(out[0].cpu()))
        metrics, restarted = [], None
        for i in range(3):
            b = _f64_batch(jbatches[i]) if f64 else jbatches[i]
            state, m = jstep(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
            if i == 0:
                restarted = int((state.generator.code_vq.level_0.k_elem
                                 < 1.0).sum())
        runs[name] = dict(state=state, labels=labels, metrics=metrics,
                          restarted=restarted)
    torch.cuda.synchronize()
    jgaps = _gan_gaps(*(_da_tensors(torch, runs[k]["state"])
                        for k in ("card", "cpu", "f64")))
    labels_equal = [bool(torch.equal(a, b)) for a, b in
                    zip(runs["card"]["labels"], runs["cpu"]["labels"])]
    jrel = max(_rel(a[k], b[k]) for a, b in zip(runs["card"]["metrics"],
                                                runs["cpu"]["metrics"])
               for k in ("loss_disc", "loss_gen_all", "mel_error", "commit"))
    card = runs["card"]["state"]
    del runs["cpu"]["state"], runs["f64"]["state"]
    # a NaN batch under skip_nonfinite, on the card
    before = _da_snapshot(torch, card)
    card, mb = jstep(card, jbatches[3])
    nan_equal = _same(torch, before, _da_snapshot(torch, card))
    skips = (int(mb["nonfinite_skips"]), card.g_guard.notfinite_count,
             card.d_guard.notfinite_count)
    # the candidates' generator through g_/do_
    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(tmp)
        save_gan_checkpoint(ck, card, card.step, wait=True)
        other = _da_state(torch, jcfg, jtrees, "cuda",
                          seed=DA_JOINT_SEED + 1, **cut)
        other, had_g, had_do = restore_gan_checkpoint(ck, other)
    restored = (had_g and had_do and other.step == card.step
                and torch.equal(other.rng.get_state(), card.rng.get_state())
                and _same(torch, _da_snapshot(torch, other),
                          _da_snapshot(torch, card)))
    del card, other
    joint = {"geometry": "content_vq's, B = 2 x %d code samples, the two "
             "items equal; MPD period 2, one MSD scale" % DA_JOINT_T,
             "labels_equal_each_step": labels_equal,
             "codes_restarted_on_first_step": runs["card"]["restarted"],
             "loss_gen_all_card": [m["loss_gen_all"]
                                   for m in runs["card"]["metrics"]],
             "commit_card": [m["commit"] for m in runs["card"]["metrics"]],
             "losses_max_rel": jrel, "card_vs_cpu": jgaps,
             "nan_batch_bit_equal": nan_equal, "skips": skips,
             "checkpoint_restores_step_codebook_rng": restored,
             "seconds": time.perf_counter() - t1}
    ok &= (len(labels_equal) == 3 and all(labels_equal)
           and runs["card"]["restarted"] > 0 and jrel <= 1e-5
           and jgaps["ok"] and nan_equal and skips == (1, 1, 1)
           and restored)
    row = {"phase": "da_step_parity", "config": "da_hubert100_lut.json",
           "B": 2, "samples": DA_SEG, "dtype": "float32",
           "decoder_only": decoder, "joint": joint,
           "seconds": time.perf_counter() - t0, "ok": ok}
    emit(row)
    if not ok:
        raise AssertionError("DA step parity check failed")
    return row


def phase_da_train(torch) -> dict:
    """The decoder-only DA trainer at full width: configs/
    da_hubert100_lut.json (V1 at 512 channels, 320× upsampling, the full
    MPD and MSD), B = 16 × 8960 samples (its batch_size and segment_size:
    8.96 s of audio a step), one fixed `_da_batch`, the CLI's init
    (generator from seed 1234, discriminators from 1 and 2), a pitch
    quantizer of configs/f0_vqvae.json's width loaded and frozen. Eight f32
    steps, then eight with disc_bf16 from the same init: ms per step by
    CUDA events (the first apart; median, min and max of the other seven),
    trained audio-s per s, the host's time in each step call, peak memory,
    the bound (`gan_step_bound_ms` at the generator's 28 input frames);
    one more f32 step under torch.profiler (busy share). Gates: every loss
    finite, mel_error over
    each run's last three steps below its first step's, the pitch quantizer
    bit-unchanged."""
    from speech_inpainting_torch.convert.from_jax import (trainable_codegen,
                                                          trainable_fo_vqvae)
    from speech_inpainting_torch.testing import fo_vqvae_tree
    from speech_inpainting_torch.train.da import make_da_step
    from speech_inpainting_torch.train.gan import (create_gan_state,
                                                   default_discriminators)
    t0 = time.perf_counter()
    h = json.loads(IDA_CONFIG.read_text())
    rng = np.random.default_rng(SEED + 230)
    f0cfg = _da_config(h).codegen.f0_quantizer
    pitch = trainable_fo_vqvae(f0cfg, *fo_vqvae_tree(f0cfg, rng),
                               device="cpu").state_dict()
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in
             _da_batch(rng, _da_config(h).codegen, DA_B, DA_SEG).items()}
    audio_s = DA_B * DA_SEG / DA_SR
    rows, ok = {}, True
    for name, bf16 in (("f32", False), ("bf16_disc", True)):
        dcfg = _da_config(h, disc_bf16=bf16)
        torch.cuda.reset_peak_memory_stats()
        gen = trainable_codegen(dcfg.codegen, seed=1234, device="cuda")
        gen.fo_vqvae.load_state_dict(pitch)
        state = create_gan_state(dcfg.gan, gen,
                                 *default_discriminators(dcfg.gan, "cuda"))
        n_params = sum(p.numel() for p in
                       state.g_parameters() + state.d_parameters())
        step = make_da_step(dcfg)
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(8)]
        metrics, host = [], []
        t1 = time.perf_counter()
        for a, b in events:
            a.record()
            t2 = time.perf_counter()
            state, m = step(state, batch)
            host.append((time.perf_counter() - t2) * 1e3)
            b.record()
            metrics.append(m)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        ms = [a.elapsed_time(b) for a, b in events]
        metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
        med = float(np.median(ms[1:]))
        mel = [m["mel_error"] for m in metrics]
        finite = all(np.isfinite(v) for m in metrics for v in m.values())
        frozen = all(torch.equal(v.cpu(), pitch[k]) for k, v in
                     state.generator.fo_vqvae.state_dict().items())
        ok &= finite and max(mel[-3:]) < mel[0] and frozen
        rows[name] = {
            "first_step_ms": ms[0], "ms_per_step_median": med,
            "ms_per_step_min": min(ms[1:]), "ms_per_step_max": max(ms[1:]),
            "ms_per_step": ms, "wall_s_8_steps": wall,
            # the host's time in each step call (it returns once the step
            # is enqueued, bar the guard's and the metrics' reads): near
            # the step's own time, the host paces the step
            "host_ms_per_step_median": float(np.median(host[1:])),
            "audio_seconds_per_second": audio_s / (med / 1e3),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "mel_error": mel, "loss_disc": [m["loss_disc"] for m in metrics],
            "loss_gen_all": [m["loss_gen_all"] for m in metrics],
            "fo_vqvae_bit_unchanged": frozen,
            **gan_step_bound_ms(dcfg.codegen.hifigan, DA_B, DA_SEG, n_params,
                                bf16, frames=DA_SEG // DA_HOP)}
        if name == "f32":
            rows["f32_profile"] = _profile_step(torch, step, state, batch)
        del state, step, gen
    row = {"phase": "da_train", "config": "da_hubert100_lut.json",
           "regime": "decoder-only", "B": DA_B, "samples": DA_SEG,
           "audio_seconds_per_step": audio_s, **rows,
           "seconds": time.perf_counter() - t0, "ok": ok}
    emit(row)
    if not ok:
        raise AssertionError("DA training run check failed")
    return row


def phase_train_da_cli(torch, ida, d: Path) -> dict:
    """`train_da.main` on the card on what `prep_and_train_f0vq_cli` left
    in `d`: its units manifest (codes/train.txt, 18 utterances: one B = 16
    step an epoch), its f0 statistics (the config's f0_stats) and its
    train_f0vq directory (--f0-quantizer), configs/da_hubert100_lut.json,
    a validation manifest of four of the utterances, --validation-interval
    1, --epochs 1; twice, the second run resuming 1 → 2. Each run's sweep
    folds the trained generator (K2 launches counted). Then one I_da
    utterance (`ida_main`'s 4 s input, HuBERT and centroids) through
    `IdaInpainter` with the trained generator folded: K2 launches, kernel
    path vs plain path; and K2 against its plain version at the sweep's
    B and step shapes, which no earlier check holds (`ida_kernel_check`
    holds B = 1 at the 4 s utterance's lengths, `gan_valid_kernel_check`
    V1's). Gates: the checkpoints, the resume, the launches, the pitch
    quantizer equal to the directory's, the waveforms finite."""
    from speech_inpainting_torch.cli import train_da
    from speech_inpainting_torch.convert.ida_torch import (
        load_f0vq_training_checkpoint)
    from speech_inpainting_torch.data.code_dataset import mel_stats_embedder
    from speech_inpainting_torch.infer.ida_inpaint import IdaInpainter
    from speech_inpainting_torch.models.hubert import HubertConfig
    from speech_inpainting_torch.ops.resblock import (fused_resblock1,
                                                      fused_resblock_step)
    setup = ida["setup"]
    t0 = time.perf_counter()
    h = json.loads(IDA_CONFIG.read_text())
    h["f0_stats"] = str(d / "f0_stats.json")
    (d / "da.json").write_text(json.dumps(h))
    lines = (d / "codes" / "train.txt").read_text().splitlines()
    (d / "da_valid.txt").write_text("\n".join(lines[-4:]) + "\n")
    cmd = [str(a) for a in (
        "--config", d / "da.json", "--train-manifest", d / "codes" /
        "train.txt", "--valid-manifest", d / "da_valid.txt",
        "--validation-interval", 1, "--f0-quantizer", d / "f0vq",
        "--checkpoint-path", d / "da_ckpt", "--epochs", 1, "--cache-dir",
        d / "da_cache", "--device", "cuda")]
    runs = []
    for _ in range(2):
        fused_resblock_step.launches = 0
        t1 = time.perf_counter()
        state = train_da.main(cmd)
        torch.cuda.synchronize()
        runs.append({"seconds": time.perf_counter() - t1,
                     "end_step": state.step,
                     "validation_k2_launches": fused_resblock_step.launches,
                     "checkpoints": sorted(
                         p.name for p in (d / "da_ckpt").iterdir())})
    gen = state.generator
    want = load_f0vq_training_checkpoint(d / "f0vq", gen.cfg.f0_quantizer,
                                         device="cuda").state_dict()
    pitch_equal = all(torch.equal(v, want[k]) for k, v in
                      gen.fo_vqvae.state_dict().items())
    t1 = time.perf_counter()
    inp = IdaInpainter(gen.cfg, None, None, HubertConfig.base(),
                       setup["hp"], setup["centroids"], tap_layer=IDA_TAP,
                       codegen=gen.fold(), device="cuda")
    emb = mel_stats_embedder(gen.cfg.hifigan.in_dim - 2 * gen.cfg.
                             embedding_dim, device="cuda")(
        setup["utts"][0], DA_SR)
    fused_resblock_step.launches = fused_resblock1.launches = 0
    out = inp(setup["utts"][0], IDA_MASK, emb=emb)
    torch.cuda.synchronize()
    utterance_s = time.perf_counter() - t1
    launches, k1 = fused_resblock_step.launches, fused_resblock1.launches
    inp.codegen.generator.use_kernel = False
    plain = inp(setup["utts"][0], IDA_MASK, emb=emb)
    diff = max((out[k] - plain[k]).abs().max().item()
               for k in ("audio_gen", "audio_inpainted"))
    finite = all(bool(torch.isfinite(v.float()).all())
                 for k, v in out.items() if k != "rtf")
    n_valid = 4
    cfg = gen.cfg.hifigan
    stage_T, t = {}, DA_SEG // DA_HOP
    for i, u in enumerate(cfg.upsample_rates):
        t *= u
        stage_T[cfg.upsample_initial_channel // 2 ** (i + 1)] = t
    path = {"T": stage_T, "kernel_sizes": cfg.resblock_kernel_sizes,
            "dilations": cfg.resblock_dilation_sizes}
    per_call = 2 * len(cfg.upsample_rates) * sum(
        len(r) for r in cfg.resblock_dilation_sizes)
    del state, gen, inp
    ok = (runs[0]["end_step"] == 1 and runs[1]["end_step"] == 2
          and runs[0]["checkpoints"] == ["do_00000001", "g_00000001"]
          and runs[1]["checkpoints"] == ["do_00000001", "do_00000002",
                                         "g_00000001", "g_00000002"]
          and all(r["validation_k2_launches"] == per_call for r in runs)
          and pitch_equal and launches == 2 * per_call and k1 == 0
          and diff <= MAIN_ATOL and finite)
    row = {"phase": "train_da_cli", "train_utterances": len(lines),
           "valid_utterances": n_valid, "runs": runs,
           "pitch_quantizer_from_train_f0vq": pitch_equal,
           "generator_in_dim": cfg.in_dim,
           "k2_launches": launches, "k1_launches": k1,
           "kernel_vs_plain_max_abs": diff, "tolerance": MAIN_ATOL,
           "utterance_seconds": utterance_s, "finite": finite,
           "seconds": time.perf_counter() - t0, "ok": ok}
    emit(row)
    if not ok:
        raise AssertionError("train_da CLI check failed")
    errs = phase_ida_kernel_check(torch, path, B=n_valid,
                                  name="da_valid_kernel_check")
    return {**row, "kernel_check": errs, "validation_path": path}


# ---------------------------------------------------------------- scale-out

DIST_LR_STEPS = 2     # steps of each run the scale-out phases compare
EA_DIST_B = 16        # the I_ea trainer's global batch (the CLI's default)


def _event_timed(make, log: list, after=None):
    """make(...) → a step wrapped in CUDA events, each (start, end,
    metrics) appended to `log`: the ms per step of a run the CLI drives,
    and what the step returned; after(state), where given, is called after
    each step, outside the events."""
    import torch

    def wrapped(*args, **kw):
        step = make(*args, **kw)

        def timed(state, batch):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            state, metrics = step(state, batch)
            b.record()
            log.append((a, b, metrics))
            if after is not None:
                after(state)
            return state, metrics
        return timed
    return wrapped


def _cli_run(torch, module, attr: str, argv: list, after=None) -> tuple:
    """module.main(argv) with module.<attr> (its step builder) timed by
    CUDA events (and `after` called after each step): (state, [ms per
    step], [metrics per step], host seconds)."""
    log = []
    orig = getattr(module, attr)
    setattr(module, attr, _event_timed(orig, log, after))
    t0 = time.perf_counter()
    try:
        state = module.main(argv)
    finally:
        setattr(module, attr, orig)
    torch.cuda.synchronize()
    return (state, [a.elapsed_time(b) for a, b, _ in log],
            [{k: float(v) for k, v in m.items()} for _, _, m in log],
            time.perf_counter() - t0)


def _first_step_rel(runs: dict) -> float:
    """The largest relative gap between the two runs' first-step metrics
    (the same parameters and batch: the mesh must not change them)."""
    a, b = runs["mesh"]["metrics"][0], runs["plain"]["metrics"][0]
    return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in b)


def _param_gap(a, b, skip: str = NOISY) -> tuple:
    """Largest |a − b| over two modules' parameters (of the same names),
    those ending in `skip` (a zero-gradient tensor: rounding noise that
    AdamW turns into ±lr) apart: (gap, its tensor, the skipped gap)."""
    pb = dict(b.named_parameters())
    gap, where, skipped = 0.0, None, 0.0
    for n, p in a.named_parameters():
        g = float((p.detach().float() - pb[n].detach().float()).abs().max())
        if n.endswith(skip):
            skipped = max(skipped, g)
        elif g > gap:
            gap, where = g, n
    return gap, where, skipped


def _group() -> tuple:
    """(backend, world size) of this process's group, (None, 0) without
    one."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return None, 0
    return dist.get_backend(), dist.get_world_size()


EA_W1_GRAD_REL = 1e-2   # dist_world1's I_ea step-1 gradients, mesh vs plain


def phase_dist_world1(torch, ea_corpus: Path) -> dict:
    """The trainers' `--mesh` at world size 1 over NCCL on the card: with
    no launcher and no --coordinator, `--mesh` joins a process group of
    one (parallel.distributed.join_world_of_one, tcp://127.0.0.1:<free
    port>), so each step runs its gradient all_reduces, metric reduction
    and the runner's placement through NCCL; the CLI leaves the group when
    it ends. `train_hifigan --modified` on configs/hifigan_ft_modified
    .json at full width (V1 and the full MPD/MSD, B = 16 × 44 288, f32,
    --validation-interval 2: 2 steps and a sweep of 72 K2 launches) with
    and without --mesh, the states held by testing.parity_gate (`_gan_gaps`,
    the run without the mesh as reference); `train_ea --hubert-type large
    --pretrained DIR` (B = 16 × 5 s, bf16, 2 steps, on `train_ea_cli`'s
    corpus and HF directory, `ea_corpus`) with and without --mesh, the
    first step's reduced gradients (the same parameters and batch) within
    EA_W1_GRAD_REL of the largest gradient, after the clip, and their
    global norm before it within EA_W1_GRAD_REL of the plain run's (the
    clip to 10 rescales a summed loss's gradients alike, so only the norm
    before it shows a reduction that scaled them all): bf16 keeps 8
    significant bits (3.9e-3 of an element) and the card's bf16 attention
    and convolution backward are not deterministic, while a gradient that
    the reduction halved, zeroed or moved reads 0.5 or more. The parameters after 2
    steps are printed, not held: AdamW moves an element by about lr a step
    whatever its gradient, so two runs differ by at most a few lr. Both
    trainers' first-step metrics within rel 1e-5. Each step's ms by CUDA
    events around the CLI's own step: the difference is what the
    collectives cost at world size 1."""
    import tempfile
    from speech_inpainting_torch.cli import train_ea, train_hifigan
    from speech_inpainting_torch.ops.resblock import fused_resblock_step
    from speech_inpainting_torch.testing import synthetic_batch
    from speech_inpainting_torch.train import ea as ea_step
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 300)
    gan, ea, groups = {}, {}, set()
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        (d / "wavs22").mkdir()
        wavs = synthetic_batch(rng, 48, 3.0)[0]
        names = [f"utt{i:02d}" for i in range(48)]
        for n, w in zip(names, wavs):
            _write_wav(d / "wavs22" / f"{n}.wav", w, GAN_SR)
        (d / "train22.txt").write_text("\n".join(names[:32]) + "\n")
        (d / "valid22.txt").write_text("\n".join(names[32:]) + "\n")
        np.save(d / "km.npy", rng.standard_normal((100, 80)).astype(
            np.float32) - 5.0)
        gan_cmd = ["--wavs", str(d / "wavs22"), "--filelist",
                   str(d / "train22.txt"), "--valid-filelist",
                   str(d / "valid22.txt"), "--config", str(GAN_CONFIG),
                   "--modified", "--kmeans", str(d / "km.npy"),
                   "--batch-size", "16", "--epochs", "1",
                   "--validation-interval", "2", "--device", "cuda"]
        for name, extra in (("plain", []), ("mesh", ["--mesh"])):
            fused_resblock_step.launches = 0
            seen = []
            state, ms, metrics, secs = _cli_run(
                torch, train_hifigan, "make_modified_step",
                gan_cmd + ["--checkpoint-path", str(d / f"gan_{name}"),
                           *extra], after=lambda s: seen.append(_group()))
            if extra:
                groups.update(seen)
            gan[name] = {"tensors": _gan_tensors(torch, state),
                         "end_step": state.step,
                         "on_mesh": state.mesh is not None,
                         "validation_k2_launches":
                             fused_resblock_step.launches,
                         "ms_per_step": ms, "metrics": metrics,
                         "seconds": secs,
                         "checkpoints": sorted(p.name for p in (
                             d / f"gan_{name}").iterdir())}
            del state
        gaps = _gan_gaps(gan["mesh"]["tensors"], gan["plain"]["tensors"],
                         gan["plain"]["tensors"])
        for r in gan.values():
            del r["tensors"]

        e = ea_corpus
        ea_cmd = ["--wavs", str(e / "wavs"), "--split",
                  str(e / "train.txt"), "--labels-dir", str(e / "labels"),
                  "--kmeans", str(e / "km.npy"), "--hubert-type", "large",
                  "--pretrained", str(e / "hf"), "--batch-size",
                  str(EA_DIST_B), "--epochs", "1", "--device", "cuda"]
        models, grads, norms = {}, {}, {}
        clip = ea_step.clip_by_global_norm_
        for name, extra in (("plain", []), ("mesh", ["--mesh"])):
            first, seen, norm = {}, [], []

            def after(state, first=first, seen=seen):
                seen.append(_group())
                if not first:            # step 1's reduced, clipped grads
                    first.update({n: p.grad.detach().float().clone()
                                  for n, p in state.model.named_parameters()
                                  if p.grad is not None})

            def norm_then_clip(grads, max_norm, norm=norm):
                # the clip rescales every gradient alike: the global norm
                # before it shows a reduction that scaled them all
                if not norm:
                    norm.append(float(torch.linalg.vector_norm(torch.stack(
                        [torch.linalg.vector_norm(g.float())
                         for g in grads if g is not None]))))
                clip(grads, max_norm)

            ea_step.clip_by_global_norm_ = norm_then_clip
            try:
                state, ms, metrics, secs = _cli_run(
                    torch, train_ea, "make_train_step",
                    ea_cmd + ["--checkpoint-path", str(d / f"ea_{name}"),
                              *extra], after=after)
            finally:
                ea_step.clip_by_global_norm_ = clip
            if extra:
                groups.update(seen)
            models[name], grads[name], norms[name] = state.model, first, \
                norm[0]
            ea[name] = {"end_step": state.step,
                        "on_mesh": state.mesh is not None,
                        "ms_per_step": ms, "metrics": metrics,
                        "seconds": secs,
                        "checkpoints": sorted(p.name for p in (
                            d / f"ea_{name}").iterdir())}
            del state
        ea_gap, ea_where, ea_noise = _param_gap(models["mesh"],
                                                models["plain"])
        del models
        plain, mesh = grads.pop("plain"), grads.pop("mesh")
        top = max(float(g.abs().max()) for g in plain.values())
        grad_rel = max(float((mesh[n] - g).abs().max())
                       for n, g in plain.items()) / top
        same_grads = set(mesh) == set(plain)
        del plain, mesh
        norm_rel = abs(norms["mesh"] - norms["plain"]) / norms["plain"]
    gan_rel, ea_rel = _first_step_rel(gan), _first_step_rel(ea)
    left = _group()
    ok = (groups == {("nccl", 1)} and left == (None, 0) and gaps["ok"]
          and gan_rel <= 1e-5 and ea_rel <= 1e-5
          and all(r["end_step"] == 2 and r["checkpoints"] == [
              "do_00000002", "g_00000002"] for r in gan.values())
          and gan["mesh"]["on_mesh"] and not gan["plain"]["on_mesh"]
          and all(r["validation_k2_launches"] == 72 for r in gan.values())
          and all(r["end_step"] == 2 and r["checkpoints"] == [
              "ea_00000002", "last_00000000"] for r in ea.values())
          and ea["mesh"]["on_mesh"] and not ea["plain"]["on_mesh"]
          and same_grads and grad_rel <= EA_W1_GRAD_REL
          and norm_rel <= EA_W1_GRAD_REL)
    row = {"phase": "dist_world1",
           "groups_of_the_mesh_steps": sorted(map(list, groups),
                                              key=str),
           "group_left_after": left[0],
           "train_hifigan_modified_b16x44288_f32": {
               **gan, "first_step_metric_rel": gan_rel,
               "mesh_vs_plain": {k: gaps[k] for k in (
                   "share_max", "excess_max", "small_excess_max", "failed",
                   "ok")}},
           "train_ea_large_b16x5s_bf16": {
               **ea, "first_step_metric_rel": ea_rel,
               "step1_grad_rel_to_largest": grad_rel,
               "step1_grad_norm_before_clip": norms,
               "step1_grad_norm_rel": norm_rel,
               "grad_bound": EA_W1_GRAD_REL, "largest_grad": top,
               "param_gap_after_2_steps": ea_gap, "gap_tensor": ea_where,
               "k_proj_bias_gap": ea_noise},
           "seconds": time.perf_counter() - t_phase, "ok": ok}
    emit(row)
    if not ok:
        raise AssertionError("dist_world1 check failed")
    return {"validation_k2_launches": gan["mesh"]["validation_k2_launches"]}


def _w2_ea(torch, mesh) -> dict:
    """The I_ea step on this rank's 8 rows of a B = 16 global batch
    (HuBERT-base + head, 5 s, f32, 2 steps) against the world-1 step on
    all 16 rows from the same start: the losses summed over the ranks
    (a mean would halve them), the gradients and parameters."""
    from speech_inpainting_torch.convert.from_jax import trainable_hubert
    from speech_inpainting_torch.models.hubert import HubertConfig
    from speech_inpainting_torch.parallel.distributed import local_batches
    from speech_inpainting_torch.testing import hubert_tree
    from speech_inpainting_torch.train import ea
    rng = np.random.default_rng(SEED + 310)       # the same on every rank
    hcfg = HubertConfig.base()
    tree = _trained_like(hubert_tree(hcfg, 80, rng), rng)
    centroids = rng.standard_normal((100, 80)).astype(np.float32)
    batches = [_ea_batch(rng, EA_DIST_B, EA_SAMPLES, 100)
               for _ in range(DIST_LR_STEPS)]
    cfg = ea.EAConfig(mask_length=EA_MASK)
    step = ea.make_train_step(cfg, centroids, "cuda")
    runs = {}
    for name, on_mesh in (("world1", False), ("world2", True)):
        state = ea.create_state(cfg, trainable_hubert(hcfg, tree, 80,
                                                      device="cuda"))
        if on_mesh:
            state.mesh = mesh
        log, losses = [], []
        timed = _event_timed(lambda: step, log)()
        for b in (local_batches(iter(batches), mesh) if on_mesh
                  else batches):
            state, m = timed(state, b)
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        runs[name] = (state, losses,
                      [a.elapsed_time(b) for a, b, _ in log])
    (s1, l1, ms1), (s2, l2, ms2) = runs["world1"], runs["world2"]
    # the last step's clipped gradients, each gap over the model's largest
    # gradient (a mean over the ranks would read 0.5 here)
    grads1 = {n: p.grad for n, p in s1.model.named_parameters()}
    top = max(float(g.abs().max()) for g in grads1.values())
    grad_rel = max(float((p.grad - grads1[n]).abs().max()) / top
                   for n, p in s2.model.named_parameters()
                   if not n.endswith(NOISY))
    gap, where, noise = _param_gap(s2.model, s1.model)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l2, l1))
    bound = 2 * 1e-4 * DIST_LR_STEPS
    ok = loss_rel <= 1e-4 and grad_rel <= 1e-4 and gap <= bound
    return {"B_global": EA_DIST_B, "B_rank": EA_DIST_B // 2,
            "loss_world1": l1, "loss_world2": l2, "loss_rel": loss_rel,
            "last_grad_rel": grad_rel, "param_gap": gap, "gap_tensor": where,
            "k_proj_bias_gap": noise, "bound": bound,
            "ms_per_step_world1": ms1, "ms_per_step_world2": ms2, "ok": ok}


def _w2_gan(torch, mesh) -> dict:
    """The V1 GAN step (vanilla recipe, configs/hifigan_v1.json, the full
    MPD and MSD, f32) on this rank's 8 rows of a 16 × 8192 batch against
    the world-1 step on all 16 rows from the same start, every tensor by
    testing.parity_gate (`_gan_gaps`, world 1 as reference); then the
    validation sweep (gan_valid_fn: the folded generator on a replicated
    B = 8 batch, K2) on both states."""
    from speech_inpainting_torch.ops.resblock import fused_resblock_step
    from speech_inpainting_torch.parallel.distributed import local_batches
    from speech_inpainting_torch.train.hifigan import (make_vanilla_eval,
                                                       make_vanilla_step)
    from speech_inpainting_torch.train.run import gan_valid_fn
    rng = np.random.default_rng(SEED + 320)
    tcfg = _gan_cfg(CONFIGS / "hifigan_v1.json", ISTFT_SEG)
    trees = _gan_trees(torch, tcfg.hifigan, rng)
    batch = {"audio": _gan_audio(rng, 16, ISTFT_SEG)}
    val = [{"audio": _gan_audio(rng, 8, ISTFT_SEG)}]
    step = make_vanilla_step(tcfg)
    valid_fn = gan_valid_fn(make_vanilla_eval(tcfg), val)
    out, tensors = {}, {}
    for name, on_mesh in (("world1", False), ("world2", True)):
        state = _gan_state(torch, tcfg, trees, "cuda")
        b = batch
        if on_mesh:
            state.mesh = mesh
            b = next(local_batches(iter([batch]), mesh))
        log = []
        state, m = _event_timed(lambda: step, log)()(state, b)
        fused_resblock_step.launches = 0
        mel_error = valid_fn(state)["mel_error"]
        torch.cuda.synchronize()
        out[name] = {"metrics": {k: float(v) for k, v in m.items()},
                     "ms_step": log[0][0].elapsed_time(log[0][1]),
                     "validation_mel_error": mel_error,
                     "validation_k2_launches": fused_resblock_step.launches}
        tensors[name] = _gan_tensors(torch, state)
        del state
    gaps = _gan_gaps(tensors["world2"], tensors["world1"], tensors["world1"])
    del tensors
    m1, m2 = out["world1"]["metrics"], out["world2"]["metrics"]
    metric_rel = max(abs(m2[k] - m1[k]) / max(abs(m1[k]), 1e-12)
                     for k in m1)
    ok = (gaps["ok"] and metric_rel <= 1e-4
          and out["world2"]["validation_k2_launches"] == 72
          and abs(out["world2"]["validation_mel_error"]
                  - out["world1"]["validation_mel_error"]) <= 1e-3)
    return {**out, "metric_rel": metric_rel,
            "gate": {k: gaps[k] for k in ("share_max", "excess_max",
                                          "small_excess_max", "failed",
                                          "ok")}, "ok": ok}


def _w2_inpaint(torch, mesh, rank: int) -> dict:
    """InformedInpainter(mesh=) at the main path's full width (HuBERT-base
    + head, 100 × 80 codebook, V1) on B = 8 × 4 s: this rank's 4 rows (72
    K1 launches), gathered; against the world-1 inpainter's batch() on
    all 8 rows, waveforms atol 1e-4 and labels equal. This rank's
    inpainter starts from another codebook where rank != 0: the mesh's
    replication must give it rank 0's."""
    from speech_inpainting_torch.infer.inpaint import InformedInpainter
    from speech_inpainting_torch.ops.resblock import fused_resblock1
    from speech_inpainting_torch.testing import synthetic_batch
    cfg, hp, gp, centroids = _ea_setup(np.random.default_rng(SEED))
    w22, w16, pos, lens = synthetic_batch(np.random.default_rng(SEED + 330),
                                          8, 4.0)
    dev = [torch.as_tensor(a, device="cuda") for a in (w22, w16, pos, lens)]
    one = InformedInpainter(cfg, hp, gp, centroids)
    want = one.batch(*dev)
    one_ms = cuda_ms(lambda: one.batch(*dev), 3)
    del one
    inp = InformedInpainter(cfg, hp, gp, centroids + 0.5 * rank, mesh=mesh)
    fused_resblock1.launches = 0
    got = inp.batch(*dev)
    torch.cuda.synchronize()
    launches = fused_resblock1.launches
    gap = float((got["inpainted"] - want["inpainted"]).abs().max())
    labels = bool((got["pred_labels"] == want["pred_labels"]).all())
    mesh_ms = cuda_ms(lambda: inp.batch(*dev), 3)
    ok = launches == 72 and gap <= MAIN_ATOL and labels
    return {"B_global": 8, "B_rank": 4, "seconds_per_utterance": 4.0,
            "k1_launches": launches, "waveform_gap_vs_world1": gap,
            "labels_equal": labels, "ms_batch_world1": one_ms,
            "ms_batch_mesh": mesh_ms, "ok": ok}


def _w2_tp(torch) -> dict:
    """Tensor parallelism on the card over gloo: HuBERT-base + head
    (parallel/tp.py on a ("dp", 1) × ("tp", 2) mesh: each rank 6 of the 12
    heads and half the MLP) on B = 2 × 4 s, against the unsharded module
    on the same rank, head output atol 1e-3 (HUBERT_ATOL); ms per forward
    of each."""
    from speech_inpainting_torch.convert.from_jax import hubert_from_jax
    from speech_inpainting_torch.device import full_f32
    from speech_inpainting_torch.models.hubert import HubertConfig
    from speech_inpainting_torch.parallel.mesh import make_mesh
    from speech_inpainting_torch.parallel.tp import check_tp, shard_params
    from speech_inpainting_torch.testing import hubert_tree, synthetic_batch
    rng = np.random.default_rng(SEED + 340)
    hcfg = HubertConfig.base()
    model = hubert_from_jax(hcfg, hubert_tree(hcfg, 80, rng), 80,
                            device="cuda")
    wav = torch.as_tensor(synthetic_batch(rng, 2, 4.0)[1], device="cuda")
    mesh = make_mesh((("dp", 1), ("tp", 2)), device_type="cuda")
    check_tp(hcfg, mesh)
    with torch.no_grad(), full_f32():
        want = model(wav)
        whole_ms = cuda_ms(lambda: model(wav), 3)
        shard_params(mesh, model)
        got = model(wav)
        tp_ms = cuda_ms(lambda: model(wav), 3)
    gap = float((got - want).abs().max())
    q = model.hubert.layers[0].attention.q_proj.weight
    sharded = tuple(q.to_local().shape) == (q.shape[0] // 2, q.shape[1])
    return {"B": 2, "seconds": 4.0, "heads_per_rank": 6, "sharded": sharded,
            "head_output_gap": gap, "tolerance": HUBERT_ATOL,
            "ms_forward_unsharded": whole_ms, "ms_forward_tp2": tp_ms,
            "ok": sharded and gap <= HUBERT_ATOL}


def dist_worker(torch, rank: int, world: int, port: int, d: Path) -> int:
    """One rank of the two that share the card (`--dist-worker`): a gloo
    group over tcp://127.0.0.1:<port> (NCCL refuses two ranks on one
    device), a ("dp",) mesh on "cuda", then the world-2 checks and the
    tensor-parallel one; the results to d/rank<r>.json."""
    import torch.distributed as dist
    from speech_inpainting_torch.parallel.mesh import make_mesh
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    mesh = make_mesh(device_type="cuda")
    out = {"rank": rank, "world": dist.get_world_size(),
           "backend": dist.get_backend()}
    for name, fn in (("ea_step", lambda: _w2_ea(torch, mesh)),
                     ("gan_step", lambda: _w2_gan(torch, mesh)),
                     ("inpainter", lambda: _w2_inpaint(torch, mesh, rank)),
                     ("tp_forward", lambda: _w2_tp(torch))):
        t0 = time.perf_counter()
        out[name] = fn()
        out[name]["seconds"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    (d / f"rank{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()
    return 0


def phase_dist_world2_one_card(torch) -> dict:
    """Two worker processes (this script with --dist-worker), both on
    cuda:0 in a gloo group: each runs `_w2_ea`, `_w2_gan`, `_w2_inpaint`
    and `_w2_tp` and writes its results; a worker that fails fails the
    phase. Prints one line per check and rank (`dist_world2_one_card`,
    `tp_world2_one_card`), with its seconds."""
    import tempfile
    from speech_inpainting_torch.parallel.mesh import free_port
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        port = free_port()
        logs = [open(d / f"rank{r}.log", "w") for r in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--dist-worker",
             str(r), "2", str(port), str(d)],
            stdout=logs[r], stderr=subprocess.STDOUT) for r in range(2)]
        # a rank that fails leaves the other waiting in a collective: stop
        # both at the first failure, or at the deadline
        deadline = time.perf_counter() + 600
        try:
            while any(p.poll() is None for p in procs):
                if any(p.poll() for p in procs) or \
                        time.perf_counter() > deadline:
                    break
                time.sleep(1)
        finally:
            for p, log in zip(procs, logs):
                if p.poll() is None:
                    p.kill()
                p.wait()
                log.close()
        bad = [(r, p.returncode) for r, p in enumerate(procs)
               if p.returncode]
        if bad:
            for (r, rc) in bad:
                tail = (d / f"rank{r}.log").read_text()[-6000:]
                print(f"dist worker {r} exited {rc}:\n{tail}",
                      file=sys.stderr, flush=True)
            raise AssertionError(f"dist workers failed: {bad}")
        res = [json.loads((d / f"rank{r}.json").read_text())
               for r in range(2)]
    seconds = time.perf_counter() - t0
    tp = {"phase": "tp_world2_one_card", "backend": res[0]["backend"],
          "ranks": [r["tp_forward"] for r in res],
          "ok": all(r["tp_forward"]["ok"] for r in res)}
    row = {"phase": "dist_world2_one_card", "backend": res[0]["backend"],
           "world_size": res[0]["world"],
           "gather": "all_reduce of a zeroed buffer (gloo gathers no CUDA "
                     "tensor)",
           "ranks": [{k: r[k] for k in ("rank", "ea_step", "gan_step",
                                        "inpainter")} for r in res],
           "seconds": seconds,
           "ok": all(r[k]["ok"] for r in res
                     for k in ("ea_step", "gan_step", "inpainter"))}
    emit(row)
    emit(tp)
    if not (row["ok"] and tp["ok"]):
        raise AssertionError("dist_world2_one_card check failed")
    return {"k1_launches_per_rank": [r["inpainter"]["k1_launches"]
                                     for r in res],
            "k2_launches_per_rank": [
                r["gan_step"]["world2"]["validation_k2_launches"]
                for r in res]}


def control_unpinned(torch) -> int:
    """The control of `default_flags` (`--unpinned`): the entry points'
    pinning (`device.full_f32`) is made a no-op before they are imported,
    and the phase runs alone; it must then come out not ok. Exits 0 when
    the phase caught the missing pinning, 1 when it did not."""
    import contextlib
    from speech_inpainting_torch import device

    @contextlib.contextmanager
    def no_pinning():
        yield

    assert not any(m.startswith("speech_inpainting_torch.infer")
                   for m in sys.modules)
    device.full_f32 = no_pinning
    phase_device(torch)
    phase_build()
    try:
        phase_default_flags(torch, _ea_setup(np.random.default_rng(SEED)),
                            _ida_setup(torch))
    except AssertionError as err:
        emit({"control": "unpinned", "default_flags_failed": True,
              "error": str(err)})
        return 0
    emit({"control": "unpinned", "default_flags_failed": False})
    return 1


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    import speech_inpainting_torch  # noqa: F401  (fails outside the repo)
    torch.backends.cudnn.benchmark = False
    if sys.argv[1:] == ["--unpinned"]:
        return control_unpinned(torch)
    if sys.argv[1:2] == ["--dist-worker"]:
        rank, world, port, d = sys.argv[2:6]
        return dist_worker(torch, int(rank), int(world), int(port), Path(d))
    info = phase_device(torch)
    spills = phase_build()
    errs = phase_kernel_check(torch)
    edge = phase_edge_check(torch)
    path = phase_main(torch)
    timed = phase_kernel_time(torch, path["T"])
    ida = phase_ida_main(torch)
    ida_errs = phase_ida_kernel_check(torch, ida)
    ida_timed = phase_ida_kernel_time(torch, ida)
    phase_default_flags(torch, path["setup"], ida["setup"])
    covered = _covered_tiles(path)
    large = phase_ea_large(torch)
    istft = phase_istft_engine(torch, path["setup"])
    phase_artifacts(torch, path["setup"])
    serving = phase_serving(torch, path["setup"], covered)
    longform = phase_longform(torch, path["setup"])
    cli = phase_cli(torch, large)
    large_launches = large["launches"]
    del large
    import tempfile
    with tempfile.TemporaryDirectory() as aot_dir:
        aot = phase_aot_export(torch, path["setup"], Path(aot_dir))
    with tempfile.TemporaryDirectory() as aot_dir:
        aot_cli = phase_export_aot_cli(torch, path["setup"], Path(aot_dir))
    phase_int8_hubert(torch, path["setup"])
    ida_cli = phase_ida_cli(torch, ida)
    with tempfile.TemporaryDirectory() as eval_dir:
        ev = phase_evaluate_sweep(torch, path["setup"], covered,
                                  Path(eval_dir))
        phase_score_cli(torch, ev, Path(eval_dir))
    asr = phase_predict_asr_cli(torch, ida)
    voc = phase_vocode(torch)
    phase_v3(torch)
    phase_f0vq(torch)
    cvq = phase_content_vq(torch)
    phase_kmeans_fit(torch)
    phase_ea_train_parity(torch)
    phase_ea_train(torch)
    # train_ea_cli's corpus and HuBERT-large directory, kept for dist_world1
    ea_corpus = tempfile.TemporaryDirectory()
    tcli = phase_train_ea_cli(torch, Path(ea_corpus.name))
    phase_gan_step_parity(torch)
    phase_gan_train(torch)
    gcli = phase_train_hifigan_cli(torch)
    phase_istft_gan_step_parity(torch)
    ist = phase_istft_gan_train(torch, path["setup"], covered)
    f0ds, f0_corpus_s = _f0_corpus(torch)
    phase_f0vq_step_parity(torch, f0ds)
    phase_f0vq_train(torch, f0ds, f0_corpus_s)
    del f0ds
    phase_da_step_parity(torch)
    phase_da_train(torch)
    with tempfile.TemporaryDirectory() as prep_dir:
        f0cli = phase_prep_and_train_f0vq_cli(torch, ida, Path(prep_dir))
        dcli = phase_train_da_cli(torch, ida, Path(prep_dir))
    w1 = phase_dist_world1(torch, Path(ea_corpus.name))
    ea_corpus.cleanup()
    w2 = phase_dist_world2_one_card(torch)
    taken = {"I_ea": _plan_tiles(4, path["T"], path["kernel_sizes"],
                                 path["dilations"]),
             "I_da": _plan_tiles(1, ida["T"], ida["kernel_sizes"],
                                 ida["dilations"]),
             "vocode": _plan_tiles(1, voc["path"]["T"],
                                   voc["path"]["kernel_sizes"],
                                   voc["path"]["dilations"]),
             "train_hifigan_validation": _plan_tiles(
                 GAN_B, gcli["validation_sweep"]["path"]["T"],
                 gcli["validation_sweep"]["path"]["kernel_sizes"],
                 gcli["validation_sweep"]["path"]["dilations"]),
             "train_hifigan_istft_validation": _plan_tiles(
                 GAN_B, ist["path"]["T"], ist["path"]["kernel_sizes"],
                 ist["path"]["dilations"]),
             "train_da_validation": _plan_tiles(
                 4, dcli["validation_path"]["T"],
                 dcli["validation_path"]["kernel_sizes"],
                 dcli["validation_path"]["dilations"])}
    emit({"phase": "spills", "instantiations": [
        {**r, "taken_by": [name for name, tiles in taken.items()
                           if (r["co_tile"], r["t_tile"], r["K"]) in tiles]}
        for r in spills]})
    t, t2 = timed["bfloat16"], ida_timed["bfloat16"]
    emit({"kernels": [{
        "name": "fused_resblock1", "route": "cuda",
        "source": "speech_inpainting_torch/csrc/resblock1.cu",
        "replaces": "speech_inpainting_tpu/ops/pallas_resblock.py:266",
        "launches": path["launches"],
        # K1's launches on each path's run (counts set to 0 just before):
        # one V1 forward (base, large), one iSTFT-engine forward, the eight
        # B = 64 serving batches at depth 4, the long-form recording's one
        # batch of 8 windows, the CLI's three vocoder calls, the same three
        # from the I_ea trainer's last_ checkpoint and from the GAN trainer's
        # g_ (training launches none), the evaluation sweep's three (wav,
        # mask length) batches, each a `batch` and a `batch_expected` of B =
        # 8, the iSTFT trainer's validation sweep (one B = 16 forward of the
        # folded ISTFTGenerator), one B = 4 batch of the inpainter with
        # the generator it trained, and each rank's 4 rows of a B = 8
        # batch of the mesh inpainter (two ranks on the card, gloo)
        "launches_by_path": {
            "I_ea_hubert_base_v1": path["launches"],
            "I_ea_hubert_large_v1": large_launches,
            "istft_engine": istft["launches"],
            "serving_b64_depth4_8_batches": serving["launches"],
            "longform_60s": longform["launches"],
            "cli_predict_ea": cli["launches"],
            "train_ea_cli_predict_ea_from_last": tcli["launches"],
            "predict_ea_from_trained_g": gcli["predict_ea_k1_launches"],
            "evaluate_sweep_3_lengths_x_8_positions": ev["launches"],
            "aot_artifact_v1_f32_per_batch": aot["launches"]["v1_float32"],
            "aot_artifact_v1_bf16_per_batch":
                aot["launches"]["v1_bfloat16"],
            "aot_artifact_istft_per_batch": aot["launches"]["istft_float32"],
            "export_aot_cli_artifact_per_batch": aot_cli["launches"],
            "train_hifigan_istft_validation_sweep":
                ist["cli_runs"][0]["validation_k1_launches"],
            "istft_trained_inpainter_per_batch":
                ist["inpainter_k1_launches"],
            "dist_world2_mesh_inpainter_rank0":
                w2["k1_launches_per_rank"][0],
            "dist_world2_mesh_inpainter_rank1":
                w2["k1_launches_per_rank"][1]},
        # the worst over the checks: V1's 12 (C, K) shapes at B=2,
        # T=2049, the main path's 12 shapes at B=4, the edge shapes, and
        # the evaluation sweep's B = 8 and the iSTFT trainer's validation
        # sweep's B = 16 tiles no earlier check reached
        "max_abs_err": max(errs["f32_max_abs_err"], timed["float32"]["err"],
                           edge["K1"]["f32_max_abs_err"],
                           *(r["err"] for r in ev["kernel_check_rows"]),
                           *(r["err"] for r in ist["kernel_check_rows"])),
        "bf16_rel_err": max(errs["bf16_rel_err"], timed["bfloat16"]["err"],
                            edge["K1"]["bf16_rel_err"]),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "timed_at": "the 12 ResBlock1 calls of one V1 forward, B=4 x 4 s, "
                    "bfloat16, summed",
        "f32_ms": timed["float32"]["ms"],
        "f32_plain_ms": timed["float32"]["plain_ms"],
        "f32_library_ms": timed["float32"]["library_ms"],
        # 3×TF32 on the tensor cores, the route the f32 kernel takes; the
        # FMA figure (67 TFLOP/s outside them) beside it
        "f32_bound_ms": timed["float32"]["bound_ms"],
        "f32_bound_fma_ms": timed["float32"]["bound_fma_ms"],
        # the `torch.ops.si.resblock1` route (FastGenerator's, eager and
        # exported) beside the direct call: per forward, and host µs per
        # call at ROUTE_SHAPE
        "op_ms": t["op_ms"], "f32_op_ms": timed["float32"]["op_ms"],
        "route_us": {"bfloat16": t["route"],
                     "float32": timed["float32"]["route"]},
        "ms_by_C": {C: v["ms"] for C, v in t["by_C"].items()},
        "f32_ms_by_C": {C: v["ms"] for C, v in
                        timed["float32"]["by_C"].items()}}, {
        "name": "fused_resblock_step", "route": "cuda",
        "source": "speech_inpainting_torch/csrc/resblock1.cu",
        "replaces": "speech_inpainting_tpu/ops/pallas_resblock.py:126",
        "launches": ida["launches"],
        # K2's launches on each path's run (counts set to 0 just before):
        # one I_da utterance (two vocoder calls), the inpaint_da CLI per
        # utterance per mask, one V1 forward of the vocode CLI (wav2wav,
        # --quantize-mel and mel2wav alike), one content-VQ forward, the GAN
        # trainer's validation sweep (one B = 16 forward of the folded
        # generator), one vocode forward from the g_ it wrote, one I_da
        # utterance whose pitch quantizer train_f0vq trained, the unit
        # HiFi-GAN trainer's validation sweep (one B = 4 forward of the
        # folded CodeGenerator), one I_da utterance through the
        # CodeGenerator it trained, the ASR→TTS baseline's donor
        # rendering (predict_asr --donor: two vocoder calls), one B = 4
        # batch of the exported artifact with a plain Generator override
        # (through the operator si::resblock_step), the validation sweep of
        # `train_hifigan --mesh` at world size 1 (NCCL), and each rank's
        # validation sweep of the world-2 GAN step (B = 8, replicated)
        "launches_by_path": {
            "I_da_utterance": ida["launches"],
            "inpaint_da_cli_per_utterance_per_mask":
                ida_cli["launches_per_utterance_per_mask"],
            "vocode_v1_forward": voc["launches_per_forward"],
            "content_vq_forward": cvq["launches"],
            "train_hifigan_validation_sweep":
                gcli["runs"][0]["validation_k2_launches"],
            "vocode_from_trained_g_per_forward":
                gcli["vocode_k2_launches_per_forward"],
            "I_da_utterance_with_trained_pitch_quantizer":
                f0cli["k2_launches"],
            "train_da_validation_sweep":
                dcli["runs"][0]["validation_k2_launches"],
            "I_da_utterance_with_trained_codegen": dcli["k2_launches"],
            "predict_asr_donor_rendering": asr["launches"],
            "aot_artifact_v1_plain_generator_per_batch":
                aot["k2_launches"],
            "dist_world1_train_hifigan_mesh_validation_sweep":
                w1["validation_k2_launches"],
            "dist_world2_gan_validation_sweep_rank0":
                w2["k2_launches_per_rank"][0],
            "dist_world2_gan_validation_sweep_rank1":
                w2["k2_launches_per_rank"][1]},
        # the worst over the I_da generator's 45 step shapes, V1's 36 at
        # the vocode CLI's lengths and 36 at the GAN trainer's validation
        # sweep (B = 16), the I_da generator's 45 at the DA trainer's sweep
        # (B = 4, 8960 samples), and the edge shapes
        "max_abs_err": max(ida_errs["f32_max_abs_err"],
                           voc["kernel_check"]["f32_max_abs_err"],
                           gcli["kernel_check"]["f32_max_abs_err"],
                           dcli["kernel_check"]["f32_max_abs_err"],
                           edge["K2"]["f32_max_abs_err"]),
        "bf16_rel_err": max(ida_errs["bf16_rel_err"],
                            voc["kernel_check"]["bf16_rel_err"],
                            gcli["kernel_check"]["bf16_rel_err"],
                            dcli["kernel_check"]["bf16_rel_err"],
                            edge["K2"]["bf16_rel_err"]),
        "ms": t2["ms"], "plain_ms": t2["plain_ms"], "bound_ms": t2["bound_ms"],
        "bound_by": t2["bound_by"], "library_ms": t2["library_ms"],
        "timed_at": "the 45 ResBlock1 steps of one I_da vocoder call, B=1, "
                    "4 s, bfloat16, summed",
        "f32_ms": ida_timed["float32"]["ms"],
        "f32_plain_ms": ida_timed["float32"]["plain_ms"],
        "f32_library_ms": ida_timed["float32"]["library_ms"],
        "f32_bound_ms": ida_timed["float32"]["bound_ms"],
        "f32_bound_fma_ms": ida_timed["float32"]["bound_fma_ms"],
        # `torch.ops.si.resblock_step` (the route of an exported plain
        # Generator; eager calls stay direct) beside the direct call
        "op_ms": t2["op_ms"], "f32_op_ms": ida_timed["float32"]["op_ms"],
        "route_us": {"bfloat16": t2["route"],
                     "float32": ida_timed["float32"]["route"]},
        "ms_by_C": {C: v["ms"] for C, v in t2["by_C"].items()},
        "f32_ms_by_C": {C: v["ms"] for C, v in
                        ida_timed["float32"]["by_C"].items()}}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
