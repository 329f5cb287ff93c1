"""Informed inpainting of one recording (the I_ea predict path), on the card.

Counterpart of speech_inpainting_tpu/cli/predict_ea.py: loads the wav at
22.05 k and 16 k, runs `InformedInpainter`, and writes the reference's
artifact set: orig, masked, hifi_masked and inpainted wavs,
expected_inpaint with --labels, and mel PNGs.

  python -m speech_inpainting_torch.cli.predict_ea \\
      --wav x.wav --start-sec 1.0 --end-sec 1.2 \\
      --hubert-checkpoint best.pt --hifigan-checkpoint g_02500000 \\
      --kmeans model.npy --out prediction/

`--long-form` streams windows of a recording of any length through the
same inpainter (`infer/longform.py`), any number of `--mask` spans:

  python -m speech_inpainting_torch.cli.predict_ea \\
      --wav hour_long.wav --long-form --mask 61.2-61.4 --mask 1803.0-1803.3 \\
      --hubert-checkpoint ... --hifigan-checkpoint ... --kmeans model.npy

Checkpoints: the encoder as a reference `CustomModel` state dict
(.pt/.pth/.bin), the JAX package's numpy pickle of its `EncoderWithHead`
tree (.pkl), or a `best_`/`last_` file of the port's trainer
(`cli/train_ea.py`: `{"model": state_dict}` of the trainable model, whose
weight norm is folded at load); the generator as a reference `g_*` file or
a numpy pickle of its `Generator` tree (.pkl). Orbax checkpoint directories
are not read.
Runs on the CUDA card; `--device cpu` runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
from pathlib import Path

import numpy as np
import torch

from ..convert.from_jax import inference_hubert
from ..convert.hifigan_torch import load_generator_checkpoint
from ..convert.hubert_torch import convert_custom_model
from ..data.audio import load_wav, save_wav
from ..infer.inpaint import InformedInpainter, InpainterConfig
from ..models.hifigan import HiFiGANConfig
from ..models.hubert import EncoderWithHead, HubertConfig
from ..ops.masking import mask_wave_frames
from ..quantize.kmeans import KMeans


def save_fig(mel, out_dir, name):
    """A mel spectrogram as `name`.png (needs matplotlib, imported here)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(10, 4))
    im = ax.imshow(np.asarray(mel), aspect="auto", origin="lower",
                   interpolation="none")
    fig.colorbar(im, ax=ax)
    fig.savefig(Path(out_dir) / f"{name}.png", bbox_inches="tight")
    plt.close(fig)


def _unreadable(path: str, what: str, readable: str) -> ValueError:
    return ValueError(
        f"{what} {path!r}: the PyTorch port reads {readable}; orbax "
        "checkpoint directories are not read (orbax is a JAX library)")


def _pickle(path: str) -> dict:
    with open(path, "rb") as fh:
        return pickle.load(fh)


def load_trained_hubert(path, cfg: HubertConfig, device) -> EncoderWithHead:
    """A trainer's `best_`/`last_` file → the inference EncoderWithHead on
    `device`, weight norm folded, convs and dense layers stored in
    cfg.dtype, its head as wide as the checkpoint's."""
    sd = torch.load(path, map_location="cpu", weights_only=True)["model"]
    model = EncoderWithHead(cfg, sd["head.linear.weight"].shape[0],
                            weight_norm=True)
    model.load_state_dict(sd)
    return inference_hubert(model.to(device))


def load_inpainter(args) -> InformedInpainter:
    """The inpainter of the CLI's checkpoints, on `args.device`."""
    centroids = KMeans.load_auto(args.kmeans).centroids
    hcfg = (HubertConfig.large() if args.hubert_type == "large"
            else HubertConfig.base())
    gcfg = HiFiGANConfig()
    if args.hifigan_config:
        gcfg = HiFiGANConfig.from_dict(
            json.loads(Path(args.hifigan_config).read_text()))
    device = args.device
    hp, gp, hubert, generator = None, None, None, None

    ckpt = args.hubert_checkpoint
    if ckpt.endswith((".pt", ".pth", ".bin")):
        sd = torch.load(ckpt, map_location="cpu", weights_only=True)
        hubert = convert_custom_model(sd, hcfg, device=device)
    elif ckpt.endswith(".pkl"):
        hp = _pickle(ckpt)
    elif os.path.isfile(ckpt):
        hubert = load_trained_hubert(ckpt, hcfg, device)
    else:
        raise _unreadable(ckpt, "--hubert-checkpoint",
                          "a CustomModel state dict (.pt/.pth/.bin), a "
                          "numpy pickle of the EncoderWithHead tree (.pkl) "
                          "or a trainer's best_/last_ file")

    ckpt = args.hifigan_checkpoint
    if ckpt.endswith(".pkl"):
        gp = _pickle(ckpt)
    elif Path(ckpt).name.startswith("g_"):
        generator = load_generator_checkpoint(ckpt, gcfg, device=device)
    else:
        raise _unreadable(ckpt, "--hifigan-checkpoint",
                          "a reference g_* file or a numpy pickle of the "
                          "Generator tree (.pkl)")
    return InformedInpainter(InpainterConfig(hubert=hcfg, hifigan=gcfg),
                             hp, gp, centroids, hubert=hubert,
                             generator=generator, device=device)


def parse_mask_spans(start_sec, end_sec, masks):
    """Mask specs (seconds) → (mask_pos, mask_len) on the global 20 ms frame
    grid (pos from the 16 k / 320-hop convention)."""
    spans = []
    for s in masks or []:
        a, _, b = s.partition("-")
        spans.append((float(a), float(b)))
    if (start_sec is None) != (end_sec is None):
        raise ValueError("--start-sec and --end-sec must be given together")
    if start_sec is not None:
        spans.append((start_sec, end_sec))
    if not spans:
        raise ValueError("give --start-sec/--end-sec or at least one --mask")
    if any(b <= a for a, b in spans):
        raise ValueError("mask end must be after its start")
    pos = np.array([int(a * 16000) // 320 for a, b in spans], np.int64)
    # round the ms count first: int() would turn (1.2 − 1.0)·1000 into 199 ms,
    # 9 frames instead of 10
    ln = np.array([max(round((b - a) * 1000) // 20, 1) for a, b in spans],
                  np.int64)
    return pos, ln


def write_artifacts(inp: InformedInpainter, wav22, wav16, mask_pos: int,
                    mask_len: int, out_dir, labels=None, *,
                    figures: bool = True) -> np.ndarray:
    """One utterance's artifact set in `out_dir`: orig (16 k), masked
    (16 k), hifi_masked and inpainted (22.05 k), expected_inpaint with
    `labels`, and, with `figures`, the mel PNGs (masked, inpainted,
    expected). Returns the predicted codewords inside the mask."""
    out_dir = Path(out_dir)
    save_wav(out_dir / "orig.wav", wav16, 16000)
    out = inp(wav22, wav16, mask_pos, mask_len)
    save_wav(out_dir / "inpainted.wav", out["inpainted"].cpu().numpy(),
             22050)
    save_wav(out_dir / "hifi_masked.wav",
             inp.hifi_masked(wav22, mask_pos, mask_len).cpu().numpy(), 22050)
    save_wav(out_dir / "masked.wav",
             mask_wave_frames(torch.as_tensor(wav16), mask_pos,
                              mask_len).numpy(), 16000)
    mels = {"masked": out["mel_masked"], "inpainted": out["mel_inpainted"]}
    if labels is not None:
        exp = inp.expected_inpaint(wav22, labels, mask_pos, mask_len)
        save_wav(out_dir / "expected_inpaint.wav",
                 exp["expected_inpaint"].cpu().numpy(), 22050)
        mels["expected"] = exp["mel_expected"]
    if figures:
        for name, mel in mels.items():
            save_fig(mel.cpu().numpy(), out_dir, name)
    return out["pred_labels"].cpu().numpy()[mask_pos:mask_pos + mask_len]


def main(argv=None, *, figures: bool = True):
    """The CLI; `figures=False` writes no mel PNGs (where matplotlib is
    not installed)."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--wav", required=True)
    p.add_argument("--start-sec", type=float, default=None)
    p.add_argument("--end-sec", type=float, default=None)
    p.add_argument("--mask", action="append", metavar="START-END",
                   help="mask span in seconds, repeatable "
                        "(e.g. --mask 1.0-1.2 --mask 5.3-5.5)")
    p.add_argument("--long-form", action="store_true",
                   help="windowed streaming over a recording of any length "
                        "(writes orig/masked/inpainted + spans.json)")
    p.add_argument("--window-sec", type=float, default=4.0,
                   help="long-form window length")
    p.add_argument("--batch", type=int, default=8,
                   help="long-form windows per batch call")
    p.add_argument("--hubert-checkpoint", required=True)
    p.add_argument("--hubert-type", default="large",
                   choices=["base", "large"])
    p.add_argument("--hifigan-checkpoint", required=True)
    p.add_argument("--hifigan-config", default=None)
    p.add_argument("--kmeans", required=True)
    p.add_argument("--labels", default=None,
                   help="target frame labels (.npy) for expected_inpaint")
    p.add_argument("--out", default="prediction")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the CUDA card)")
    args = p.parse_args(argv)

    wav22, _ = load_wav(args.wav, target_sr=22050)
    wav16, _ = load_wav(args.wav, target_sr=16000)
    try:
        pos_arr, len_arr = parse_mask_spans(args.start_sec, args.end_sec,
                                            args.mask)
    except ValueError as e:
        p.error(str(e))
    if len(pos_arr) > 1 and not args.long_form:
        p.error("multiple --mask spans require --long-form")

    inp = load_inpainter(args)
    out_dir = Path(args.out) / Path(args.wav).stem
    os.makedirs(out_dir, exist_ok=True)

    if args.long_form:
        from ..infer.longform import LongFormConfig, LongFormInpainter
        cfg = LongFormConfig(window_frames=max(int(args.window_sec * 50), 16),
                             batch=args.batch)
        try:
            out, spans = LongFormInpainter(inp, cfg)(wav22, wav16,
                                                     pos_arr, len_arr)
        except ValueError as e:
            # e.g. a mask longer than the window holds
            p.error(f"{e} (try a larger --window-sec)")
        masked = wav22.copy()
        for q, n in zip(pos_arr, len_arr):
            masked[q * 441:(q + n) * 441] = 0.0
        save_wav(out_dir / "orig.wav", wav22, 22050)
        save_wav(out_dir / "masked.wav", masked, 22050)
        save_wav(out_dir / "inpainted.wav", out, 22050)
        (out_dir / "spans.json").write_text(json.dumps(
            {"pasted_sample_spans": [[int(a), int(b)] for a, b in spans],
             "sr": 22050}))
        print(f"{len(pos_arr)} mask(s) inpainted; artifacts -> {out_dir}")
        return

    labels = np.load(args.labels) if args.labels else None
    codes = write_artifacts(inp, wav22, wav16, int(pos_arr[0]),
                            int(len_arr[0]), out_dir, labels,
                            figures=figures)
    print("Predicted codewords:", codes)
    print(f"artifacts -> {out_dir}")


if __name__ == "__main__":
    main()
