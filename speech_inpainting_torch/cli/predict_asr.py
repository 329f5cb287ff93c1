"""ASR→TTS inpainting-baseline CLI (replaces the I_ea/predict_asr.py
script, whose "CLI" is a constants block, predict_asr.py:23-59); the
counterpart of speech_inpainting_tpu/cli/predict_asr.py.

Takes a masked utterance and a mask span, obtains a synthetic rendering of
the utterance, and splices the mask-covering synthetic span back in via the
VAD→MFCC-DTW→WSOLA→crossfade chain (infer/asr_baseline.py, ops/dsp.py).

The synthetic rendering comes from one of (mirroring the reference's
step_asr/step_tts switches):
  --synth out.wav      a pre-rendered TTS waveform (step_tts=0,
                       predict_asr.py:55 — the external-TTS path; no
                       zero-shot TTS ships with this package)
  --donor donor.wav + the I_da stack flags — the in-house UnitResynthTTS
                       leg: the donor recording of the target text is
                       re-voiced through HuBERT units + CodeGenerator
                       (speaker-conditioned, acoustically independent of
                       the donor waveform)

Artifacts: orig.wav, speaker_wav.wav, output_tts.wav and
mask_synth_stretched.wav match the reference's names exactly
(predict_asr.py:69-231); the reference's orig_inpainted.wav /
orig_inpainted_with_silence.wav are written here as inpainted.wav
(cropped grid) / inpainted_with_silence.wav, plus a transcript.txt the
reference never writes — adapted names, same content.

  python -m speech_inpainting_torch.cli.predict_asr --input masked.wav \
      --mask 1.5:1.7 --synth tts.wav --out p310_026_asr
  python -m speech_inpainting_torch.cli.predict_asr --input masked.wav \
      --mask 1.5:1.7 --donor donor.wav --config h.json \
      --codegen-checkpoint g_00400000 --hubert hubert-base-ls960/ \
      --kmeans km.npy --out outdir

`--codegen-checkpoint` is the reference's CodeGenerator `g_*` file;
`--hubert` a local HF checkpoint directory (config.json and
pytorch_model.bin; hub names are not downloaded). The I_da stack of
`--donor` runs on the CUDA card (its vocoder's ResBlock1 steps in K2);
`--device cpu` runs it on the CPU. The splice chain is host numpy.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..convert.hubert_torch import load_hf_pretrained
from ..convert.ida_torch import load_code_generator_checkpoint
from ..data.audio import load_wav, save_wav
from ..data.code_dataset import mel_stats_embedder
from ..device import resolve_device
from ..infer.asr_baseline import (ASRBaselineConfig, UnitResynthTTS,
                                  asr_tts_baseline)
from ..infer.ida_inpaint import IdaInpainter
from ..models.codegen import CodeGeneratorConfig
from ..quantize.kmeans import KMeans

SR = 16000   # audio_sr (predict_asr.py:39)


def _parse_span(s: str) -> tuple:
    try:
        a, b = (float(v) for v in s.split(":"))
    except ValueError:
        raise SystemExit(f"--mask wants start:end seconds, got {s!r}")
    if not 0 <= a < b:
        raise SystemExit(f"--mask span must satisfy 0 <= start < end: {s!r}")
    return (a, b)


def _build_unit_tts(args):
    """The I_da stack as the TTS leg on `args.device` (same artifact
    loading as cli/inpaint_da.py; UnitResynthTTS docstring has the
    semantics)."""
    device = resolve_device(args.device)
    h = json.loads(Path(args.config).read_text())
    ccfg = CodeGeneratorConfig.from_dict(h)
    codegen = load_code_generator_checkpoint(args.codegen_checkpoint, ccfg,
                                             device=device)
    hcfg, hubert = load_hf_pretrained(args.hubert, device=device)
    km = KMeans.load_auto(args.kmeans)
    inp = IdaInpainter(ccfg, None, None, hcfg, None, km.centroids,
                       tap_layer=args.layer,
                       code_hop=h.get("code_hop_size", 320), codegen=codegen,
                       hubert=hubert, device=device)
    embedder = mel_stats_embedder(h.get("embedding_dim", 128),
                                  device=device)
    return UnitResynthTTS(inp, embedder=embedder)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input", required=True,
                   help="the masked utterance (reference feeds masked.wav)")
    p.add_argument("--mask", required=True,
                   help="mask span in seconds, start:end (mask_pos, "
                        "predict_asr.py:31)")
    p.add_argument("--out", required=True)
    p.add_argument("--synth", help="pre-rendered TTS waveform (step_tts=0)")
    p.add_argument("--donor",
                   help="donor recording of the target text for the "
                        "in-house UnitResynthTTS leg")
    p.add_argument("--config", help="I_da config JSON (with --donor)")
    p.add_argument("--codegen-checkpoint", help="torch g_* (with --donor)")
    p.add_argument("--hubert",
                   help="local HF checkpoint directory (with --donor)")
    p.add_argument("--layer", type=int, default=6)
    p.add_argument("--kmeans", help="unit k-means (with --donor)")
    p.add_argument("--speaker-wav", nargs="+", default=[],
                   help="conditioning wavs, concatenated "
                        "(step_build_speaker_wav, predict_asr.py:110-119)")
    p.add_argument("--transcript",
                   help="target text recorded to transcript.txt; also what "
                        "an external TTS should be fed (step_asr=0)")
    p.add_argument("--no-crop-silence", action="store_true",
                   help="skip the energy-VAD crop (step_crop_audio=0)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the --donor stack (default: the "
                        "CUDA card)")
    args = p.parse_args(argv)
    if bool(args.synth) == bool(args.donor):
        p.error("give exactly one of --synth or --donor")
    if args.donor and not all((args.config, args.codegen_checkpoint,
                               args.hubert, args.kmeans)):
        p.error("--donor needs --config --codegen-checkpoint --hubert "
                "--kmeans")

    span = _parse_span(args.mask)
    # the TTS leg first: a missing card is refused before anything is written
    tts = _build_unit_tts(args) if args.donor else None
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    y_masked, _ = load_wav(args.input, target_sr=SR)
    save_wav(out / "orig.wav", y_masked, SR)

    speaker = None
    if args.speaker_wav:
        speaker = np.concatenate(
            [load_wav(f, target_sr=SR)[0] for f in args.speaker_wav])
        save_wav(out / "speaker_wav.wav", speaker, SR)

    transcript = args.transcript
    if args.synth:
        y_synth, _ = load_wav(args.synth, target_sr=SR)
    else:
        donor, _ = load_wav(args.donor, target_sr=SR)
        y_synth = np.asarray(tts(donor, speaker), np.float32)
        transcript = transcript or f"<donor:{Path(args.donor).name}>"

    cfg = ASRBaselineConfig(crop_silence=not args.no_crop_silence)
    res = asr_tts_baseline(y_masked, span, y_synth=y_synth,
                           transcript=transcript, speaker_wav=speaker,
                           cfg=cfg)

    save_wav(out / "output_tts.wav", y_synth, SR)
    save_wav(out / "mask_synth_stretched.wav", res["patch"], SR)
    save_wav(out / "inpainted.wav", res["inpainted"], SR)
    save_wav(out / "inpainted_with_silence.wav",
             res["inpainted_with_silence"], SR)
    if isinstance(res.get("transcript"), str):
        (out / "transcript.txt").write_text(res["transcript"] + "\n")
    print(f"baseline artifacts -> {out} (mask {span[0]:.2f}-{span[1]:.2f}s, "
          f"patch {len(res['patch']) / SR:.3f}s)")
    return res


if __name__ == "__main__":
    main()
