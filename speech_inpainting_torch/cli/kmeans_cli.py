"""k-means tooling on the card: mel feature dump, codebook fit, label dump.

Counterpart of speech_inpainting_tpu/cli/kmeans_cli.py (the reference's
offline pipeline I_ea/dataset/mel_dump.py, kmeans_learn.py, km_label.py):
dump per-utterance hop-441 mels and a flat frame matrix, fit the codebook
on the card, and write per-utterance frame labels and centroid mels.

  python -m speech_inpainting_torch.cli.kmeans_cli dump \\
      --wavs DIR --split F --out DIR
  python -m speech_inpainting_torch.cli.kmeans_cli fit \\
      --features F.npy --k 100 --out model.npy
  python -m speech_inpainting_torch.cli.kmeans_cli label \\
      --wavs DIR --split F --model M --out DIR

Runs on the CUDA card; `--device cpu` runs on the CPU.
"""
from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np
import torch

from ..data.audio import load_wav
from ..data.manifests import read_split_list
from ..device import full_f32, resolve_device
from ..ops.mel import HUBERT_ALIGNED_MEL_22K, mel_spectrogram
from ..quantize.kmeans import KMeans, fit_kmeans


def _wav_names(args):
    if args.split:
        return [line.split("|")[0] for line in read_split_list(args.split)]
    return [p.stem for p in sorted(Path(args.wavs).glob("*.wav"))]


def _mel(args, name) -> torch.Tensor:
    """The hop-441 log-mel (80, frames) of `name`.wav, on the device."""
    wav, _ = load_wav(Path(args.wavs) / f"{name}.wav", target_sr=22050)
    return mel_spectrogram(torch.as_tensor(wav, device=args.device),
                           HUBERT_ALIGNED_MEL_22K)


@torch.inference_mode()
@full_f32()
def cmd_dump(args):
    os.makedirs(args.out, exist_ok=True)
    frames = []
    for name in _wav_names(args):
        mel = _mel(args, name).cpu().numpy()
        np.save(Path(args.out) / f"{name}_mel.npy", mel)
        frames.append(mel.T)
    flat = np.concatenate(frames, axis=0)
    np.save(Path(args.out) / "train_valid.npy", flat)
    print(f"dumped {len(frames)} mels, {flat.shape[0]} frames "
          f"-> {args.out}/train_valid.npy")


def cmd_fit(args):
    feats = np.load(args.features, mmap_mode="r")
    C, inertia = fit_kmeans(feats, args.k, iters=args.iters, seed=args.seed,
                            n_init=args.n_init, device=args.device)
    KMeans(C.cpu().numpy()).save(args.out)
    print(f"fitted k={args.k} on {feats.shape[0]} frames, "
          f"inertia {inertia:.5f} -> {args.out}")


@torch.inference_mode()
@full_f32()
def cmd_label(args):
    km = KMeans.load_auto(args.model)
    os.makedirs(args.out, exist_ok=True)
    for name in _wav_names(args):
        labels = km(_mel(args, name).t()).cpu().numpy().astype(np.int32)
        np.save(Path(args.out) / f"{name}_labels.npy", labels)
        np.save(Path(args.out) / f"{name}_mel_c.npy", km.centroids[labels].T)
    print(f"labeled -> {args.out}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dump")
    d.add_argument("--wavs", required=True)
    d.add_argument("--split", default=None)
    d.add_argument("--out", required=True)
    f = sub.add_parser("fit")
    f.add_argument("--features", required=True)
    f.add_argument("--k", type=int, default=100)
    f.add_argument("--iters", type=int, default=50)
    f.add_argument("--n-init", type=int, default=3)
    f.add_argument("--seed", type=int, default=1234)
    f.add_argument("--out", required=True)
    lab = sub.add_parser("label")
    lab.add_argument("--wavs", required=True)
    lab.add_argument("--split", default=None)
    lab.add_argument("--model", required=True)
    lab.add_argument("--out", required=True)
    for s in sub.choices.values():
        s.add_argument("--device", default="cuda",
                       help="torch device to run on (default: the CUDA card)")
    args = p.parse_args(argv)
    args.device = resolve_device(args.device)
    {"dump": cmd_dump, "fit": cmd_fit, "label": cmd_label}[args.cmd](args)


if __name__ == "__main__":
    main()
