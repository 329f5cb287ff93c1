"""Data preparation CLI: dataset acquisition, resample/trim/pad,
manifests, unit quantization, HuBERT features, f0 statistics, VCTK/LJSpeech
split generation.

Counterpart of speech_inpainting_tpu/cli/prep.py, with its subcommands,
flags and files, which replace the reference's offline scripts
(I_da/scripts/{preprocess,create_manifest,quantize_with_kmeans,
parse_hubert_codes,f0_stats}.py and the split logic of
I_ea/dataset/preprocessing.py). `download` fetches, extracts and (for
VCTK) converts a corpus (data/download.py); with `--skip-download` it
works from an archive already placed under --root, fetching nothing:

  python -m speech_inpainting_torch.cli.prep download --dataset VCTK \
      --root corpora --skip-download

The user's I_da preparation:

  python -m speech_inpainting_torch.cli.prep preprocess --root raw --out wavs
  python -m speech_inpainting_torch.cli.prep manifest --root wavs --dest m
  python -m speech_inpainting_torch.cli.prep features --manifest m/train.tsv \
      --hubert hubert-base-ls960/ --out feats/train.npy      (→ kmeans_cli)
  python -m speech_inpainting_torch.cli.prep quantize --manifest m/train.tsv \
      --hubert hubert-base-ls960/ --kmeans km.npy --out m/units.txt
  python -m speech_inpainting_torch.cli.prep parse-codes \
      --manifest m/train.tsv --units m/units.txt --outdir data
  python -m speech_inpainting_torch.cli.prep f0-stats \
      --manifest data/train.txt --out data/f0_stats.json
  python -m speech_inpainting_torch.cli.train_f0vq ... --train-manifest \
      data/train.txt

`--hubert` takes a local HF checkpoint directory (config.json and
pytorch_model.bin, read by convert/hubert_torch.py), never a hub name.
HuBERT, k-means and the f0 tracker run on the CUDA card; `--device cpu`
runs them on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import numpy as np
import torch

from ..device import full_f32, resolve_device


def cmd_preprocess(args):
    """resample → trim silence (top_db 20) → pad to ×1280 (preprocess.py)."""
    from ..data.audio import load_wav, pad_to_multiple, save_wav, trim_silence
    os.makedirs(args.out, exist_ok=True)
    for p in sorted(Path(args.root).rglob("*.wav")):
        wav, _ = load_wav(p, target_sr=args.sr)
        wav = pad_to_multiple(trim_silence(wav, top_db=args.top_db), 1280)
        save_wav(Path(args.out) / p.name, wav, args.sr)
    print(f"preprocessed -> {args.out}")


def cmd_manifest(args):
    from ..data.manifests import create_tsv_manifest
    create_tsv_manifest(args.root, args.dest, ext=args.ext,
                        valid_percent=args.valid_percent, seed=args.seed)
    print(f"manifest -> {args.dest}")


def _hubert_feature_iter(manifest, hubert, layer, sample_pct=1.0, seed=1234,
                         device=None):
    """Yield (relpath, features (frames, hidden) float32 numpy) over a tsv
    manifest — the shared core of `quantize` and `features` (reference
    `get_feature_iterator`, `I_da/src/utils.py:41-81`, incl. its
    `sample_pct` random subsampling used to bound k-means-fit memory).
    Each wav is zero-padded to a whole second and run without an attention
    mask, as the JAX CLI runs it (the padding moves the real frames'
    features too), then cut to its own (len − 400) // 320 + 1 frames."""
    from ..convert.hubert_torch import load_hf_pretrained
    from ..data.audio import load_wav
    from ..data.manifests import read_tsv_manifest
    device = resolve_device(device)
    _, model = load_hf_pretrained(hubert, device=device)
    root, rows = read_tsv_manifest(manifest)
    if sample_pct < 1.0:
        rng = np.random.default_rng(seed)
        keep = rng.choice(len(rows), max(1, int(sample_pct * len(rows))),
                          replace=False)
        rows = [rows[i] for i in sorted(keep)]
    for rel, _ in rows:
        wav, _ = load_wav(root / rel, target_sr=16000)
        pad = (-len(wav)) % 16000
        x = torch.as_tensor(np.pad(wav, (0, pad)), device=device)[None]
        with torch.inference_mode(), full_f32():
            feats = model(x, tap_layer=layer)[0]
        n = (len(wav) - 400) // 320 + 1
        yield rel, feats[:n].float().cpu().numpy()


def cmd_quantize(args):
    """HuBERT features → k-means units file (quantize_with_kmeans.py)."""
    from ..data.manifests import write_units_file
    from ..quantize.kmeans import KMeans
    device = resolve_device(args.device)
    km = KMeans.load_auto(args.kmeans)
    entries = []
    for rel, feats in _hubert_feature_iter(args.manifest, args.hubert,
                                           args.layer, device=device):
        with torch.inference_mode(), full_f32():
            units = km(torch.as_tensor(feats, device=device))
        entries.append((Path(rel).stem, units.cpu().numpy()))
    write_units_file(args.out, entries)
    print(f"units -> {args.out}")


def cmd_features(args):
    """Manifest → HuBERT-layer features on disk (get_and_dump_features,
    `I_da/src/utils.py:114-144`): flattened .npy for k-means fitting (the
    manifest is copied alongside, as the reference does), plus optional
    per-utterance kaldi ark/scp export (save_dict_kaldimat,
    `I_da/src/utils.py:346-356` — written directly, no kaldi binary)."""
    import shutil
    mats, flat = [], []
    for rel, feats in _hubert_feature_iter(args.manifest, args.hubert,
                                           args.layer,
                                           sample_pct=args.sample_pct,
                                           seed=args.seed,
                                           device=args.device):
        mats.append((Path(rel).stem, feats))
        flat.append(feats)
    if not flat:
        raise SystemExit(f"manifest {args.manifest} has no rows "
                         "(after --sample-pct subsampling)")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.save(out, np.concatenate(flat, axis=0))
    mcopy = out.parent / Path(args.manifest).name
    if mcopy.resolve() != Path(args.manifest).resolve():
        shutil.copyfile(args.manifest, mcopy)
    print(f"features ({sum(len(f) for f in flat)} frames) -> {out}")
    if args.kaldi:
        from ..utils.kaldi import write_mats
        ark, scp = write_mats(mats, args.kaldi)
        print(f"kaldi -> {ark} + {scp}")


def cmd_parse_codes(args):
    """tsv + units → JSON-lines manifests with split (parse_hubert_codes)."""
    from ..data.manifests import join_tsv_units, random_split, write_manifest
    entries = join_tsv_units(args.manifest, args.units, dedup=args.dedup)
    train, valid, test = random_split(entries,
                                      valid_percent=args.valid_percent,
                                      test_percent=args.test_percent,
                                      seed=args.seed)
    os.makedirs(args.outdir, exist_ok=True)
    for name, part in (("train", train), ("val", valid), ("test", test)):
        write_manifest(Path(args.outdir) / f"{name}.txt", part)
    print(f"{len(train)}/{len(valid)}/{len(test)} -> {args.outdir}")


def cmd_f0_stats(args):
    """Per-speaker f0 mean/std (scripts/f0_stats.py) via the on-device
    tracker (the CUDA card, or --device)."""
    from ..data.audio import load_wav
    from ..data.manifests import parse_manifest, parse_speaker
    from ..data.code_dataset import _extract_f0_bucketed
    from ..ops.f0 import F0Config, f0_statistics
    device = resolve_device(args.device)
    files, _ = parse_manifest(args.manifest)
    per_spk = {}
    for f in files:
        spk = parse_speaker(f, args.speaker_method)
        wav, _ = load_wav(f, target_sr=16000)
        per_spk.setdefault(spk, []).append(
            _extract_f0_bucketed(wav, F0Config(), device))
    spk_names = sorted(per_spk)
    stats = {i: f0_statistics(per_spk[s]) for i, s in enumerate(spk_names)}
    out = {"speakers": spk_names,
           "stats": {str(k): v for k, v in stats.items()}}
    Path(args.out).write_text(json.dumps(out, indent=2))
    print(f"f0 stats for {len(spk_names)} speakers -> {args.out}")


def cmd_splits(args):
    """Train/validation split generation (I_ea/dataset/preprocessing.py
    regimes): VCTK-style 'speaker_textid' names split so that validation
    holds unseen speakers, unseen texts, or both; speaker p315 excluded
    (no transcripts in VCTK, the reference convention). LJSpeech uses the
    plain ratio split."""
    rng = np.random.default_rng(args.seed)
    names = sorted(p.stem.replace("_mic1", "")
                   for ext in ("wav", "flac")
                   for p in Path(args.root).rglob(f"*.{ext}"))
    names = [n for n in names if not n.startswith(args.exclude_speaker)]
    if args.only_speaker:
        # single-speaker debug subset (selection_for_debug.py's p304 regime)
        names = [n for n in names if n.split("_")[0] == args.only_speaker]
    os.makedirs(args.dest, exist_ok=True)

    def write(train, valid):
        Path(args.dest, "training.txt").write_text(
            "\n".join(train) + "\n")
        Path(args.dest, "validation.txt").write_text(
            "\n".join(valid) + "\n")
        print(f"{len(train)} train / {len(valid)} valid -> {args.dest}")

    if args.regime == "ratio":                      # LJSpeech-style
        order = rng.permutation(len(names))
        cut = int(args.ratio * len(names))
        write([names[i] for i in order[:cut]],
              [names[i] for i in order[cut:]])
        return
    speakers = sorted({n.split("_")[0] for n in names})
    texts = sorted({n.split("_", 1)[1] for n in names if "_" in n})
    spk_cut = int(args.ratio * len(speakers))
    txt_cut = int(args.ratio * len(texts))
    train_spk = set(np.array(speakers)[rng.permutation(len(speakers))
                                       [:spk_cut]])
    train_txt = set(np.array(texts)[rng.permutation(len(texts))[:txt_cut]])
    train, valid = [], []
    for n in names:
        spk = n.split("_")[0]
        txt = n.split("_", 1)[1] if "_" in n else ""
        seen_spk = spk in train_spk
        seen_txt = txt in train_txt
        if args.regime == "speakers":
            (train if seen_spk else valid).append(n)
        elif args.regime == "texts":
            (train if seen_txt else valid).append(n)
        else:  # both: validation = unseen speaker AND unseen text;
            #          train = seen speaker AND seen text; rest dropped
            if seen_spk and seen_txt:
                train.append(n)
            elif not seen_spk and not seen_txt:
                valid.append(n)
    write(train, valid)


def cmd_summary(args):
    """Split-statistics report (I_ea/dataset/preprocessing.py:62-118
    ``summary``): utterance/speaker/text counts per split, validation
    percentages, and the train∩valid speaker/text overlaps — the overlap
    lines are how the reference sanity-checks the three VCTK regimes
    ('both' must report 0 common speakers AND 0 common texts)."""
    def load(path):
        names = [ln.split("|")[0].strip()
                 for ln in Path(path).read_text().splitlines() if ln.strip()]
        spk = [n.split("_")[0] for n in names]
        txt = [n.split("_", 1)[1] for n in names if "_" in n]
        return names, spk, txt

    root = Path(args.dest)
    tr, tr_s, tr_t = load(args.training or root / "training.txt")
    va, va_s, va_t = load(args.validation or root / "validation.txt")
    print(f"# of utterances in training set: {len(tr)}")
    print(f"# of utterances in validation set: {len(va)}")
    if tr:
        print(f"{len(va) / len(tr) * 100:.2f}% utterances as validation")
    uts, uvs = set(tr_s), set(va_s)
    utt, uvt = set(tr_t), set(va_t)
    print(f"# of unique speakers in training set: {len(uts)}")
    print(f"# of unique speakers in validation set: {len(uvs)}")
    if uts:
        print(f"{len(uvs) / len(uts) * 100:.2f}% speakers as validation")
    print(f"# of unique texts in training set: {len(utt)}")
    print(f"# of unique texts in validation set: {len(uvt)}")
    if utt:
        print(f"{len(uvt) / len(utt) * 100:.2f}% unique texts as validation")
    print(f"# of common unique speakers between training&validation: "
          f"{len(uts & uvs)}")
    print(f"# of common unique texts between training&validation: "
          f"{len(utt & uvt)}")


def cmd_download(args):
    """Dataset acquisition (preprocessing.py's __main__ flow): the archive
    (skipped where it is already there), its extraction, and for VCTK the
    mic1 flacs as 22.05 kHz wavs."""
    from ..data.download import fetch_dataset
    dest = fetch_dataset(args.dataset, args.root,
                         skip_download=args.skip_download)
    print(f"dataset ready at {dest}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("download")
    s.add_argument("--dataset", required=True,
                   choices=["LJSpeech", "VCTK"])
    s.add_argument("--root", default=".")
    s.add_argument("--skip-download", action="store_true",
                   help="the archive is already under --root: fetch "
                        "nothing")

    s = sub.add_parser("splits")
    s.add_argument("--root", required=True)
    s.add_argument("--dest", required=True)
    s.add_argument("--regime", default="ratio",
                   choices=["ratio", "speakers", "texts", "both"])
    s.add_argument("--ratio", type=float, default=0.9)
    s.add_argument("--exclude-speaker", default="p315")
    s.add_argument("--only-speaker", default=None,
                   help="restrict to one speaker (fast debug subsets)")
    s.add_argument("--seed", type=int, default=1234)

    s = sub.add_parser("summary")
    s.add_argument("--dest", default=".",
                   help="directory holding training.txt/validation.txt")
    s.add_argument("--training", default=None)
    s.add_argument("--validation", default=None)

    s = sub.add_parser("preprocess")
    s.add_argument("--root", required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--sr", type=int, default=16000)
    s.add_argument("--top-db", type=float, default=20.0)

    s = sub.add_parser("manifest")
    s.add_argument("--root", required=True)
    s.add_argument("--dest", required=True)
    s.add_argument("--ext", default="wav")
    s.add_argument("--valid-percent", type=float, default=0.0)
    s.add_argument("--seed", type=int, default=42)

    s = sub.add_parser("quantize")
    s.add_argument("--manifest", required=True)
    s.add_argument("--hubert", required=True)
    s.add_argument("--layer", type=int, default=6)
    s.add_argument("--kmeans", required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")

    s = sub.add_parser("features")
    s.add_argument("--manifest", required=True)
    s.add_argument("--hubert", required=True)
    s.add_argument("--layer", type=int, default=6)
    s.add_argument("--sample-pct", type=float, default=1.0)
    s.add_argument("--seed", type=int, default=1234)
    s.add_argument("--out", required=True,
                   help="flattened features .npy (k-means fit input)")
    s.add_argument("--kaldi", default=None,
                   help="also write per-utterance <prefix>.ark/.scp")
    s.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")

    s = sub.add_parser("parse-codes")
    s.add_argument("--manifest", required=True)
    s.add_argument("--units", required=True)
    s.add_argument("--outdir", required=True)
    s.add_argument("--dedup", action="store_true")
    s.add_argument("--valid-percent", type=float, default=0.05)
    s.add_argument("--test-percent", type=float, default=0.05)
    s.add_argument("--seed", type=int, default=42)

    s = sub.add_parser("f0-stats")
    s.add_argument("--manifest", required=True)
    s.add_argument("--speaker-method", default="_")
    s.add_argument("--out", required=True)
    s.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")

    args = p.parse_args(argv)
    {"download": cmd_download, "splits": cmd_splits, "summary": cmd_summary,
     "preprocess": cmd_preprocess, "manifest": cmd_manifest,
     "quantize": cmd_quantize, "features": cmd_features,
     "parse-codes": cmd_parse_codes,
     "f0-stats": cmd_f0_stats}[args.cmd](args)


if __name__ == "__main__":
    main()
