"""Vocoder inference on the card: wav → mel → wav, mel (.npy) → wav, and
content-VQ unit extraction.

Counterpart of speech_inpainting_tpu/cli/vocode.py (the reference's
I_ea/hifi_gan/inference.py, inference_e2e.py, inference_modified.py's
replace_mel_cluster demo as --quantize-mel, and
I_da/scripts/infer_vqvae_codes.py):

  python -m speech_inpainting_torch.cli.vocode wav2wav \\
      --input-dir test_files --checkpoint g_02500000 --out generated_files
  python -m speech_inpainting_torch.cli.vocode mel2wav --input-dir mels \\
      --checkpoint g_02500000 --out generated_files_from_mel
  python -m speech_inpainting_torch.cli.vocode codes --config cfg.json \\
      --checkpoint g_00100000 --manifest val.txt --out codes.txt

The generator is `models/hifigan.py:Generator`, as the JAX CLI's: its
ResBlock1s run in K2 (two launches per residual step); V1/V2 (ResBlock1)
and V3 (ResBlock2) `g_*` files are read, with `--config` giving the
config's JSON (V1 by default). Runs on the CUDA card; `--device cpu` runs
on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import numpy as np
import torch

from ..convert.hifigan_torch import load_generator_checkpoint
from ..data.audio import load_wav, peak_normalize, save_wav
from ..device import full_f32, resolve_device
from ..models.hifigan import Generator, HiFiGANConfig
from ..ops.mel import VOCODER_MEL_22K, mel_spectrogram
from ..quantize.kmeans import KMeans


def _load_generator(checkpoint, config=None, device=None):
    """(Generator of the `g_*` file, its HiFiGANConfig) on `device`."""
    gcfg = HiFiGANConfig.from_dict(
        json.loads(Path(config).read_text())) if config else HiFiGANConfig()
    return load_generator_checkpoint(checkpoint, gcfg, device=device,
                                     cls=Generator), gcfg


def replace_mel_span_with_centroids(mel: torch.Tensor, km: KMeans,
                                    start: int, length: int) -> torch.Tensor:
    """The replace_mel_cluster listening demo (inference_modified.py:75-89):
    a copy of mel (1, 80, T) with frames [start, start+length) replaced by
    each frame's nearest k-means centroid, to hear the quantization floor.
    The reference hardcodes frames [50, 250)."""
    m = mel.clone()
    span = m[0, :, start:start + length]                 # (80, L)
    m[0, :, start:start + length] = km.quantize(span.t()).t()
    return m


@torch.inference_mode()
@full_f32()
def cmd_wav2wav(args):
    gen, gcfg = _load_generator(args.checkpoint, args.config, args.device)
    km = None
    if args.quantize_mel:
        km = KMeans.load_auto(args.quantize_mel)
        q_start, q_len = (int(v) for v in args.quantize_span.split(":"))
    os.makedirs(args.out, exist_ok=True)
    for p in sorted(Path(args.input_dir).glob("*.wav")):
        wav, _ = load_wav(p, target_sr=gcfg.sampling_rate)
        wav = torch.as_tensor(peak_normalize(wav, 0.95), device=args.device)
        mel = mel_spectrogram(wav[None], VOCODER_MEL_22K)
        suffix = "_generated"
        if km is not None:
            mel = replace_mel_span_with_centroids(mel, km, q_start, q_len)
            suffix = "_generated_quantized"
        out = gen(mel)[0, 0].float().cpu().numpy()
        save_wav(Path(args.out) / f"{p.stem}{suffix}.wav", out,
                 gcfg.sampling_rate)
    print(f"-> {args.out}")


@torch.inference_mode()
@full_f32()
def cmd_mel2wav(args):
    gen, gcfg = _load_generator(args.checkpoint, args.config, args.device)
    os.makedirs(args.out, exist_ok=True)
    for p in sorted(Path(args.input_dir).glob("*.npy")):
        mel = np.load(p)
        if mel.ndim == 2:
            mel = mel[None]
        out = gen(torch.as_tensor(mel, dtype=torch.float32,
                                  device=args.device))[0, 0]
        save_wav(Path(args.out) / f"{p.stem}_generated_e2e.wav",
                 out.float().cpu().numpy(), gcfg.sampling_rate)
    print(f"-> {args.out}")


@torch.inference_mode()
@full_f32()
def cmd_codes(args):
    from ..convert.ida_torch import load_code_generator_checkpoint
    from ..data.manifests import parse_manifest
    from ..models.codegen import CodeGeneratorConfig
    h = json.loads(Path(args.config).read_text())
    ccfg = CodeGeneratorConfig.from_dict(h)
    if not ccfg.content_vq:
        raise ValueError("codes extraction needs a lambda_commit_code "
                         "(content-VQ) config")
    m = load_code_generator_checkpoint(args.checkpoint, ccfg,
                                       device=args.device)
    files, _ = parse_manifest(args.manifest)
    with open(args.out, "w") as f:
        for p in files:
            wav, _ = load_wav(p, target_sr=h.get("sampling_rate", 16000))
            x = torch.as_tensor(wav, device=args.device)[None, None, :]
            units = m.encode_codes(x)[0].cpu().numpy()
            f.write(Path(p).stem + "|" +
                    ",".join(str(int(u)) for u in units) + "\n")
    print(f"codes -> {args.out}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("wav2wav", "mel2wav"):
        s = sub.add_parser(name)
        s.add_argument("--input-dir", required=True)
        s.add_argument("--checkpoint", required=True)
        s.add_argument("--config", default=None)
        s.add_argument("--out", required=True)
        if name == "wav2wav":
            s.add_argument("--quantize-mel", default=None, metavar="KMEANS",
                           help="replace a mel span with nearest centroids "
                                "before vocoding (replace_mel_cluster demo)")
            s.add_argument("--quantize-span", default="50:200",
                           metavar="START:LEN",
                           help="frame span to quantize (reference default)")
    s = sub.add_parser("codes")
    s.add_argument("--config", required=True)
    s.add_argument("--checkpoint", required=True)
    s.add_argument("--manifest", required=True)
    s.add_argument("--out", required=True)
    for s in sub.choices.values():
        s.add_argument("--device", default="cuda",
                       help="torch device to run on (default: the CUDA card)")
    args = p.parse_args(argv)
    args.device = resolve_device(args.device)
    {"wav2wav": cmd_wav2wav, "mel2wav": cmd_mel2wav,
     "codes": cmd_codes}[args.cmd](args)


if __name__ == "__main__":
    main()
