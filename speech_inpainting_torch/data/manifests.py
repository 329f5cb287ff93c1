"""Manifest formats: JSON-lines (I_da decoder), fairseq-style tsv, split
lists, unit files, and speaker-name parsing.

The port's own copy of speech_inpainting_tpu/data/manifests.py (numpy only;
the port imports nothing of the JAX package), behaviour matched to the
reference:
  - JSON-lines manifests {"audio": ..., "hubert"|"cpc"|"vqvae": "u1 u2 ...",
    "duration": ...} — I_da/src/dataset.py:166-205 (json.loads, not the
    reference's eval)
  - plain path-per-line lists (same function, non-'{' lines)
  - fairseq tsv: first line = root dir, then "relpath\tframes" —
    I_da/scripts/create_manifest.py:46-91
  - unit files "name|u1 u2 ..." — I_da/scripts/quantize_with_kmeans.py:70-120
  - tsv+units → JSON-lines join with ref-split or random 90/5/5 —
    I_da/scripts/parse_hubert_codes.py:31-130
  - parse_speaker 4 naming schemes — I_da/src/utils.py:256-279
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np


def parse_manifest(path) -> Tuple[List[Path], List[np.ndarray]]:
    """JSON-lines or plain-path manifest → (audio paths, unit arrays)."""
    audio_files, codes = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line[0] == "{":
                sample = json.loads(line)
                for k in ("cpc", "vqvae", "hubert"):
                    if k in sample:
                        codes.append(np.array([int(x) for x in
                                               sample[k].split()],
                                              dtype=np.int64))
                        break
                audio_files.append(Path(sample["audio"]))
            else:
                audio_files.append(Path(line))
    return audio_files, codes


def write_manifest(path, entries: Sequence[dict]):
    """Write JSON-lines entries ({'audio', 'hubert', 'duration'}...)."""
    with open(path, "w") as f:
        for e in entries:
            f.write(json.dumps(e) + "\n")


def read_tsv_manifest(path) -> Tuple[Path, List[Tuple[str, int]]]:
    """fairseq tsv → (root, [(relpath, frames), ...])."""
    with open(path) as f:
        root = Path(f.readline().strip())
        rows = []
        for line in f:
            line = line.strip()
            if not line:
                continue
            rel, frames = line.split("\t")
            rows.append((rel, int(frames)))
    return root, rows


def create_tsv_manifest(root, dest_dir, *, ext: str = "wav",
                        valid_percent: float = 0.0, seed: int = 42,
                        path_must_contain: str = "",
                        frame_counter: Optional[Callable] = None):
    """Scan `root` for audio and write train.tsv (+ valid.tsv)."""
    from .audio import wav_info
    frame_counter = frame_counter or (lambda p: wav_info(p)[1])
    root = os.path.realpath(root)
    rng = np.random.default_rng(seed)
    os.makedirs(dest_dir, exist_ok=True)
    files = sorted(str(p) for p in Path(root).rglob(f"*.{ext}")
                   if path_must_contain in str(p))
    train_lines, valid_lines = [root], [root]
    for p in files:
        line = f"{os.path.relpath(p, root)}\t{frame_counter(p)}"
        (valid_lines if rng.random() < valid_percent else train_lines
         ).append(line)
    Path(dest_dir, "train.tsv").write_text("\n".join(train_lines) + "\n")
    if valid_percent > 0:
        Path(dest_dir, "valid.tsv").write_text("\n".join(valid_lines) + "\n")


def read_units_file(path) -> List[Tuple[str, np.ndarray]]:
    """'name|u1 u2 ...' unit files → [(name, units)]."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            name, units = line.split("|")
            out.append((name, np.array([int(u) for u in units.split()],
                                       dtype=np.int64)))
    return out


def write_units_file(path, entries: Sequence[Tuple[str, np.ndarray]]):
    with open(path, "w") as f:
        for name, units in entries:
            f.write(name + "|" + " ".join(str(int(u)) for u in units) + "\n")


def join_tsv_units(tsv_path, units_path, *, dedup: bool = False
                   ) -> List[dict]:
    """fairseq tsv + unit file → JSON-lines entries (parse_hubert_codes),
    duration = frames/16000; optional run-length dedup of units."""
    root, rows = read_tsv_manifest(tsv_path)
    entries = []
    with open(units_path) as f:
        unit_lines = [l.strip() for l in f if l.strip()]
    assert len(unit_lines) == len(rows), (len(unit_lines), len(rows))
    for (rel, frames), uline in zip(rows, unit_lines):
        code = uline.split("|")[-1] if "|" in uline else uline
        if dedup:
            toks = code.split()
            code = " ".join(t for i, t in enumerate(toks)
                            if i == 0 or t != toks[i - 1])
        entries.append({"audio": str(root / rel), "hubert": code,
                        "duration": frames / 16000.0})
    return entries


def random_split(entries: Sequence, *, valid_percent: float = 0.05,
                 test_percent: float = 0.05, seed: int = 42):
    """Random train/valid/test split (parse_hubert_codes --split)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(entries))
    n_valid = int(len(entries) * valid_percent)
    n_test = int(len(entries) * test_percent)
    valid = [entries[i] for i in idx[:n_valid]]
    test = [entries[i] for i in idx[n_valid:n_valid + n_test]]
    train = [entries[i] for i in idx[n_valid + n_test:]]
    return train, valid, test


def parse_speaker(path, method: Union[str, Callable]) -> str:
    """Speaker name from a path: parent dir, grandparent dir, prefix before
    '_', the constant 'A', or a custom callable."""
    path = Path(path)
    if method == "parent_name":
        return path.parent.name
    if method == "parent_parent_name":
        return path.parent.parent.name
    if method == "_":
        return path.name.split("_")[0]
    if method == "single":
        return "A"
    if callable(method):
        return method(path)
    raise NotImplementedError(f"unknown speaker parse method {method!r}")


def read_split_list(path) -> List[str]:
    """I_ea split files: one wav name/path per line (config.yaml splits)."""
    with open(path) as f:
        return [l.strip() for l in f if l.strip()]
