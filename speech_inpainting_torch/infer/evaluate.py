"""Mask-sweep evaluation harness: the reference's mask_pos_len protocol and
batched objective scoring, the counterpart of
speech_inpainting_tpu/infer/evaluate.py.

Behaviour (the JAX package's):
  - fixture: per wav × mask length (ms), N random mask positions in samples
    within [0, len − ms·16] (I_ea/mask_pos_len.py:12-40; default lengths
    {20, 40, 60, 80, 100, 200, 300, 400} ms × 20 positions); the same seed
    gives the same positions;
  - evaluation: inpaint each (wav, mask) and score PESQ, STOI/ESTOI, SI-SDR
    and the log-spectral distances, plus the oracle (vs-expected), unit
    and WER/CER columns where their inputs are given.

All positions of one (wav, mask length) run as one batch through the
port's `InformedInpainter` on its device: the inpainted waveforms, the
`mel_inpainted`/`mel_expected`/`pred_labels` arrays and the hop-441 mels
of the reference and of the n estimates are computed there, and each
batch's results come to the host once. The metrics are host numpy
(metrics/).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import full_f32
from ..metrics.objective import log_spectral_d2, log_spectral_rmse, si_sdr
from ..metrics.pesq import pesq
from ..metrics.stoi import stoi
from ..metrics.units import (masked_unit_edits, masked_unit_error_rate,
                             unit_error_rate)
from ..ops.mel import HUBERT_ALIGNED_MEL_22K, mel_spectrogram
from .serving import force, to_host

DEFAULT_MASK_LENGTHS_MS = (20, 40, 60, 80, 100, 200, 300, 400)


def build_mask_sweep(wav_lengths: Dict[str, int],
                     mask_lengths_ms: Sequence[int] = DEFAULT_MASK_LENGTHS_MS,
                     *, n_positions: int = 20, seed: int = 1234
                     ) -> Dict[str, Dict[int, List[int]]]:
    """{wav_name: {mask_ms: [sample positions]}} (16 kHz sample scale)."""
    rng = np.random.default_rng(seed)
    sweep: Dict[str, Dict[int, List[int]]] = {}
    for name, length in wav_lengths.items():
        per_len = {}
        for ms in mask_lengths_ms:
            hi = max(1, length - ms * 16)
            per_len[int(ms)] = [int(p) for p in rng.integers(0, hi,
                                                             n_positions)]
        sweep[name] = per_len
    return sweep


def save_mask_sweep(sweep, path):
    with open(path, "w") as f:
        json.dump(sweep, f, indent=2)


def load_mask_sweep(path):
    with open(path) as f:
        raw = json.load(f)
    return {name: {int(ms): pos for ms, pos in d.items()}
            for name, d in raw.items()}


@torch.inference_mode()
@full_f32()
def _device_batch(inpainter, wav22, wav16, mask_pos, mask_len, lab):
    """Every device array one (wav, mask length) needs, on the inpainter's
    device, then brought to the host in one transfer: the inpainted
    waveforms (n, T_out), their mels, the reference's mel, and with `lab`
    the oracle's waveforms and both spliced mels with the predicted
    labels."""
    n = len(mask_pos)
    w22 = np.tile(wav22[None], (n, 1))
    out = inpainter.batch(w22, np.tile(wav16[None], (n, 1)), mask_pos,
                          mask_len)
    inpainted = out["inpainted"]
    t_out = inpainted.shape[-1]
    ref = torch.as_tensor(wav22[:t_out], dtype=torch.float32,
                          device=inpainter.device)
    res = {"inpainted": inpainted,
           "ref_mel": mel_spectrogram(ref, HUBERT_ALIGNED_MEL_22K),
           "est_mel": mel_spectrogram(inpainted, HUBERT_ALIGNED_MEL_22K)}
    if lab is not None:
        exp = inpainter.batch_expected(w22, np.tile(lab[None], (n, 1)),
                                       mask_pos, mask_len)
        res.update(expected=exp["expected_inpaint"],
                   mel_exp=exp["mel_expected"],
                   mel_inp=out["mel_inpainted"],
                   pred_labels=out["pred_labels"])
    return {k: v.numpy() for k, v in force(to_host(res)).items()}


def evaluate_inpainting(inpainter, wav22: np.ndarray, wav16: np.ndarray,
                        positions_samples: Sequence[int], mask_ms: int,
                        *, whisper=None, target_text: Optional[str] = None,
                        true_labels: Optional[np.ndarray] = None,
                        unit_scorer=None) -> Dict[str, float]:
    """Score one wav × one mask length over all positions (one device batch).

    Metrics are computed between the inpainted output and the clean 22 kHz
    waveform (trimmed to the generator's output grid). Returns means over
    positions (+ WER/CER when a WhisperScorer and target text are given).

    When `true_labels` (the full-grid oracle centroid ids, as the reference
    loads from <wav>_labels.pt, predict.py:160-163) is given, also scores the
    prediction against the reference's 'expected_inpaint' oracle — the two
    resyntheses differ ONLY inside the mask, so these isolate inpainting
    error from vocoder quality:
      *_vs_exp    — inpainted vs expected_inpaint waveform metrics
      unit_acc    — predicted centroid ids == oracle ids in the masked span
      mel_l1_mask — |mel_inpainted − mel_expected| L1 over the masked span

    `unit_scorer` (metrics.units.UnitScorer) adds `uer` — the unit error
    rate of the inpainted vs clean waveform, the offline stand-in for the
    reference's Whisper WER/CER column (I_ea/metrics.py:80-119) — and
    `uer_mask`, the same edit distance restricted to the masked span
    (metrics.units.masked_unit_error_rate), with `uer_mask_edits`, its raw
    edit count.
    """
    n = len(positions_samples)
    mask_len_frames = mask_ms // 20
    mask_pos = np.asarray([p // 320 for p in positions_samples], np.int64)
    mask_len = np.full(n, mask_len_frames, np.int64)

    lab = None
    if true_labels is not None:
        f_grid = HUBERT_ALIGNED_MEL_22K.num_frames(len(wav22))
        lab = np.zeros(f_grid, np.int64)
        n_lab = min(f_grid, len(true_labels))
        lab[:n_lab] = np.asarray(true_labels[:n_lab], np.int64)
    host = _device_batch(inpainter, np.asarray(wav22, np.float32),
                         np.asarray(wav16, np.float32), mask_pos, mask_len,
                         lab)
    inpainted = host["inpainted"]                       # (n, T_out)
    ref = wav22[:inpainted.shape[-1]]
    ref_mel = host["ref_mel"]
    m = min(ref_mel.shape[-1], host["est_mel"].shape[-1])

    scores = {"pesq": [], "stoi": [], "estoi": [], "si_sdr": [],
              "lsd_d2": [], "lsd_rmse": [], "wer": [], "cer": [],
              "pesq_vs_exp": [], "stoi_vs_exp": [], "estoi_vs_exp": [],
              "si_sdr_vs_exp": [], "unit_acc": [], "mel_l1_mask": [],
              "uer": [], "uer_mask": [], "uer_mask_edits": []}
    ref_units = unit_scorer.units(ref, 22050) if unit_scorer else None
    for i in range(n):
        est = inpainted[i]
        scores["pesq"].append(pesq(ref, est, 22050))
        scores["stoi"].append(stoi(ref, est, 22050))
        scores["estoi"].append(stoi(ref, est, 22050, extended=True))
        scores["si_sdr"].append(si_sdr(est, ref))
        est_mel = host["est_mel"][i]
        scores["lsd_d2"].append(log_spectral_d2(ref_mel[:, :m].T,
                                                est_mel[:, :m].T))
        scores["lsd_rmse"].append(log_spectral_rmse(ref_mel[:, :m].T,
                                                    est_mel[:, :m].T))
        # masks overlapping frames past the oracle track are excluded from
        # the vs-expected metrics — the padded id-0 "labels" there are
        # fabricated and would deflate unit_acc / inflate mel_l1_mask
        if (lab is not None
                and int(mask_pos[i]) + mask_len_frames <= n_lab):
            exp = host["expected"][i]
            scores["pesq_vs_exp"].append(pesq(exp, est, 22050))
            scores["stoi_vs_exp"].append(stoi(exp, est, 22050))
            scores["estoi_vs_exp"].append(stoi(exp, est, 22050,
                                               extended=True))
            scores["si_sdr_vs_exp"].append(si_sdr(est, exp))
            p, L = int(mask_pos[i]), mask_len_frames
            span_pred = host["pred_labels"][i, p:p + L]
            span_true = lab[p:p + L]
            scores["unit_acc"].append(float((span_pred == span_true).mean()))
            scores["mel_l1_mask"].append(float(np.abs(
                host["mel_inp"][i, :, p:p + L]
                - host["mel_exp"][i, :, p:p + L]).mean()))
        if whisper is not None and target_text:
            w, c, _ = whisper.wer_cer(est, 22050, target_text)
            scores["wer"].append(w)
            scores["cer"].append(c)
        if unit_scorer is not None:
            est_units = unit_scorer.units(est, 22050)
            scores["uer"].append(unit_error_rate(ref_units, est_units))
            # mask span on the 50 fps unit grid == the mel frame span;
            # denominator floored at half the margin-padded window (short
            # spans otherwise divide by 1-3 units), raw edits kept alongside
            p, L = int(mask_pos[i]), mask_len_frames
            scores["uer_mask"].append(masked_unit_error_rate(
                ref_units, est_units, (p, p + L),
                den_floor=max((L + 4) // 2, 1)))
            scores["uer_mask_edits"].append(float(masked_unit_edits(
                ref_units, est_units, (p, p + L))[0]))
    return {k: float(np.mean(v)) for k, v in scores.items() if v}


def evaluate_sweep(inpainter, wavs22: Dict[str, np.ndarray],
                   wavs16: Dict[str, np.ndarray], sweep: Dict,
                   *, whisper=None, texts: Optional[Dict[str, str]] = None,
                   labels: Optional[Dict[str, np.ndarray]] = None,
                   unit_scorer=None) -> Dict:
    """Full protocol: every wav × mask length × position. Returns
    {wav: {mask_ms: metrics}} plus 'mean' aggregates per mask length.
    `labels`: optional {wav: full-grid oracle centroid ids} enabling the
    vs-expected metrics; `unit_scorer` adds the UER intelligibility proxy
    (see evaluate_inpainting)."""
    results: Dict = {}
    for name, per_len in sweep.items():
        results[name] = {}
        for ms, positions in per_len.items():
            results[name][ms] = evaluate_inpainting(
                inpainter, wavs22[name], wavs16[name], positions, ms,
                whisper=whisper,
                target_text=(texts or {}).get(name),
                true_labels=(labels or {}).get(name),
                unit_scorer=unit_scorer)
    agg: Dict[int, Dict[str, float]] = {}
    for name, per_len in results.items():
        for ms, metrics in per_len.items():
            for k, v in metrics.items():
                agg.setdefault(ms, {}).setdefault(k, []).append(v)
    results["mean"] = {ms: {k: float(np.mean(v)) for k, v in d.items()}
                       for ms, d in agg.items()}
    return results
