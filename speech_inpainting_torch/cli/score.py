"""Objective-metric scoring CLI: PESQ / STOI / ESTOI / SI-SDR / LSD / UER
(and WER/CER when a local Whisper cache exists) over reference/degraded
waveform pairs; the counterpart of speech_inpainting_tpu/cli/score.py.

The reference exposes its metric set only as the ``Metrics`` class consumed
inside predict scripts (I_ea/metrics.py:13-141); a user who wants to score
their own files must write a script. This CLI is that script: one pair, or
two directories matched by filename, scored with the same formulas the eval
harness uses (metrics/{pesq,stoi,objective,units,asr}.py).

  python -m speech_inpainting_torch.cli.score --ref clean.wav --deg inpainted.wav
  python -m speech_inpainting_torch.cli.score --ref-dir gt/ --deg-dir out/ \
      --json scores.json
  ... --ref c.wav --deg d.wav --kmeans km.npy --mask 1.5:1.7   # + UER
  ... --ref c.wav --deg d.wav --text "the transcript"          # + WER/CER

LSD d2/RMSE use the hop-441 log-mel frontend, matching the harness
(infer/evaluate.py:93-126; reference applies the same 20/ln10-scaled
distances to mel tensors, I_ea/metrics.py:44-62). PESQ is the calibrated
P.862-structure implementation (envelope: metrics/pesq.py docstring).

The metrics are host numpy. The log-mels and the unit encoder (the hop-441
mel and the nearest mel centroid, quantize/kmeans.py:assign) run on the
CUDA card; `--device cpu` runs them on the CPU.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..data.audio import load_wav, resample
from ..device import full_f32, resolve_device
from ..metrics.objective import log_spectral_d2, log_spectral_rmse, si_sdr
from ..metrics.pesq import pesq
from ..metrics.stoi import stoi
from ..metrics.units import UnitScorer
from ..ops.mel import HUBERT_ALIGNED_MEL_22K, mel_spectrogram
from ..quantize.kmeans import KMeans, assign


def _log_mels(waves: np.ndarray, device) -> np.ndarray:
    """Hop-441 log-mels of equal-length 22.05 kHz waves (N, T) on
    `device`, (N, 80, frames) on the host."""
    with torch.inference_mode(), full_f32():
        x = torch.as_tensor(waves, dtype=torch.float32,
                            device=resolve_device(device))
        return mel_spectrogram(x, HUBERT_ALIGNED_MEL_22K).cpu().numpy()


def score_pair(ref: np.ndarray, deg: np.ndarray, sr: int, *,
               pesq_mode: str = "wb", unit_scorer=None,
               whisper=None, text: str | None = None,
               mask_span: tuple | None = None, device=None) -> dict:
    """Full metric dict for one (clean reference, degraded estimate) pair.

    Waveforms must share ``sr``; lengths are trimmed to the shorter one
    (the reference compares equal-length masked/inpainted renders).
    ``mask_span`` (start_sec, end_sec) adds `uer_mask` — UER restricted to
    the masked span (metrics/units.py), the discriminative column for
    whole-waveform resynthesis systems. The log-mels run on `device` (the
    CUDA card unless "cpu" is asked for)."""
    n = min(len(ref), len(deg))
    ref, deg = np.asarray(ref[:n], np.float32), np.asarray(deg[:n],
                                                           np.float32)
    out = {
        "pesq": float(pesq(ref, deg, sr, mode=pesq_mode)),
        "stoi": float(stoi(ref, deg, sr)),
        "estoi": float(stoi(ref, deg, sr, extended=True)),
        "si_sdr": float(si_sdr(deg, ref)),
    }
    # LSD on the hop-441 log-mel grid (22.05 kHz analysis, like the
    # eval harness) — resample if the pair lives at another rate.
    r22 = ref if sr == 22050 else resample(ref, sr, 22050)
    d22 = deg if sr == 22050 else resample(deg, sr, 22050)
    mr, md = _log_mels(np.stack([r22, d22]), device)
    m = min(mr.shape[-1], md.shape[-1])
    out["lsd_d2"] = float(log_spectral_d2(mr[:, :m].T, md[:, :m].T))
    out["lsd_rmse"] = float(log_spectral_rmse(mr[:, :m].T, md[:, :m].T))
    if unit_scorer is not None:
        out["uer"] = float(unit_scorer.uer(ref, deg, sr))
        if mask_span is not None:
            out["uer_mask"] = float(unit_scorer.masked_uer(
                ref, deg, sr, mask_span))
    if whisper is not None and text:
        w, c, hyp = whisper.wer_cer(deg, sr, text)
        out.update(wer=float(w), cer=float(c), asr_text=hyp)
    return out


def _mel_unit_scorer(kmeans_path: str, device=None):
    """UER over the I_ea mel-centroid unit system (the offline WER proxy):
    each 22.05 kHz wave's hop-441 log-mel frames, labelled by their nearest
    centroid (`.npy`, `.km` or `.bin` codebook) on `device`."""
    device = resolve_device(device)
    C = torch.as_tensor(KMeans.load_auto(kmeans_path).centroids,
                        dtype=torch.float32, device=device)

    def encode(w: np.ndarray) -> np.ndarray:
        with torch.inference_mode(), full_f32():
            x = torch.as_tensor(w, dtype=torch.float32, device=device)
            mel = mel_spectrogram(x, HUBERT_ALIGNED_MEL_22K)
            return assign(mel.T, C).cpu().numpy()

    return UnitScorer(encode, rate=22050)


def _collect_pairs(args):
    if args.ref and args.deg:
        yield Path(args.deg).stem, load_wav(args.ref), load_wav(args.deg)
        return
    refs = {p.stem: p for p in sorted(Path(args.ref_dir).glob("*.wav"))}
    degs = {p.stem: p for p in sorted(Path(args.deg_dir).glob("*.wav"))}
    missing = sorted(set(degs) - set(refs))
    if missing:
        raise SystemExit(f"no reference wav for: {', '.join(missing[:5])}")
    for name, dp in degs.items():
        yield name, load_wav(refs[name]), load_wav(dp)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ref", help="clean reference wav")
    p.add_argument("--deg", help="degraded/estimated wav")
    p.add_argument("--ref-dir", help="directory of reference wavs")
    p.add_argument("--deg-dir",
                   help="directory of degraded wavs (matched by filename)")
    p.add_argument("--kmeans", help="mel-centroid k-means model → adds UER "
                   "(offline intelligibility proxy, metrics/units.py)")
    p.add_argument("--mask", metavar="START:END",
                   help="masked span in seconds (e.g. 1.5:1.7) → adds "
                        "uer_mask, the masked-span UER (needs --kmeans); "
                        "the discriminative intelligibility column for "
                        "whole-waveform resynthesis systems")
    p.add_argument("--text", help="target transcript → adds Whisper WER/CER "
                   "when a local HF cache exists (nothing is downloaded)")
    p.add_argument("--pesq-mode", choices=("wb", "nb"), default="wb")
    p.add_argument("--json", help="also write results to this JSON file")
    p.add_argument("--device", default="cuda",
                   help="torch device of the log-mels, the unit encoder and "
                        "Whisper (default: the CUDA card)")
    args = p.parse_args(argv)
    if bool(args.ref) == bool(args.ref_dir) or bool(args.ref) != bool(
            args.deg) or bool(args.ref_dir) != bool(args.deg_dir):
        p.error("give either --ref + --deg or --ref-dir + --deg-dir")
    if args.text and args.ref_dir:
        # One transcript can't describe a directory of different utterances
        # — every WER/CER but one would score against the wrong text.
        p.error("--text only applies to single-pair mode (--ref/--deg)")

    mask_span = None
    if args.mask:
        if not args.kmeans:
            p.error("--mask needs --kmeans (uer_mask is a unit metric)")
        try:
            a, b = (float(v) for v in args.mask.split(":"))
        except ValueError:
            p.error(f"--mask wants START:END seconds, got {args.mask!r}")
        if not 0 <= a < b:
            p.error(f"--mask span must satisfy 0 <= start < end: "
                    f"{args.mask!r}")
        mask_span = (a, b)
    device = resolve_device(args.device)
    unit_scorer = (_mel_unit_scorer(args.kmeans, device)
                   if args.kmeans else None)
    whisper = None
    if args.text:
        from ..metrics.asr import WhisperScorer
        if WhisperScorer.available():
            whisper = WhisperScorer(device=device)
        else:
            print("note: no local Whisper cache — WER/CER skipped "
                  "(metrics/asr.py)")

    files = {}
    for name, (ref, sr_r), (deg, sr_d) in _collect_pairs(args):
        if sr_r != sr_d:
            deg, sr_d = resample(deg, sr_d, sr_r), sr_r
        files[name] = score_pair(ref, deg, sr_r, pesq_mode=args.pesq_mode,
                                 unit_scorer=unit_scorer, whisper=whisper,
                                 text=args.text, mask_span=mask_span,
                                 device=device)
    # Aggregate lives in its own namespace so a file named mean.wav can
    # never collide with it.
    results = {"files": files}
    if len(files) > 1:
        keys = [k for k in next(iter(files.values())) if k != "asr_text"]
        results["mean"] = {k: float(np.mean([r[k] for r in files.values()]))
                           for k in keys}
    def _show(name, r):
        cols = "  ".join(f"{k}={v:.4g}" for k, v in r.items()
                         if isinstance(v, float))
        print(f"{name}: {cols}")
    for name, r in files.items():
        _show(name, r)
    if "mean" in results:
        _show("mean", results["mean"])
    if args.json:
        Path(args.json).write_text(json.dumps(results, indent=1))
    return results


if __name__ == "__main__":
    main()
