"""Dataset acquisition: download, extract, VCTK flac→wav conversion.

Counterpart of speech_inpainting_tpu/data/download.py, after the
reference's `I_ea/dataset/preprocessing.py`:
  - `download` streams an archive over HTTP and skips it when the file is
    already there, so a host without network access works from an archive
    placed by hand; where the fetch fails and the file is absent it raises
    a RuntimeError that says where to put the archive;
  - `extract` unpacks a zip (and the zips nested in it, VCTK's layout) or a
    tar(.bz2/.gz) into the requested directory, and skips one that exists;
  - `vctk_to_wavs` decodes every `*_mic1.flac` with the port's native
    decoder (data/audio.py:load_flac, data/native.py), resamples it to
    22.05 kHz (LJSpeech's rate) and writes `<speaker>_<textnum>.wav`;
  - `fetch_dataset` runs the three for one of `DATASETS` (the reference's
    dataset/config.yaml URLs).
"""
from __future__ import annotations

import os
import tarfile
import zipfile
from pathlib import Path
from typing import Dict, Optional

DATASETS: Dict[str, Dict[str, str]] = {
    # reference I_ea/dataset/config.yaml:3-7
    "LJSpeech": {
        "url": "https://data.keithito.com/data/speech/LJSpeech-1.1.tar.bz2",
        "out_file": "LJSpeech-1.1.tar.bz2",
        "extract_to": "LJSpeech-1.1",
    },
    # reference I_ea/dataset/config.yaml:8-20
    "VCTK": {
        "url": "https://datashare.ed.ac.uk/download/DS_10283_3443.zip",
        "out_file": "VCTK-0.92.zip",
        "extract_to": "VCTK-0.92",
        "flacs_subdir": "wav48_silence_trimmed",
    },
}


def download(url: str, out_file, *, chunk_bytes: int = 1 << 20,
             progress: bool = True) -> Path:
    """Stream `url` to `out_file`; skip when the file already exists
    (preprocessing.py:17-19 — this is what makes offline use work)."""
    out = Path(out_file)
    if out.exists():
        print(f"dataset already downloaded: {out}")
        return out
    import urllib.error
    import urllib.request

    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(out.suffix + ".part")
    try:
        with urllib.request.urlopen(url) as resp, open(tmp, "wb") as f:
            total = int(resp.headers.get("Content-Length") or 0)
            done = 0
            while True:
                block = resp.read(chunk_bytes)
                if not block:
                    break
                f.write(block)
                done += len(block)
                if progress and total:
                    print(f"\r{done / 1e6:.1f}/{total / 1e6:.1f} MB",
                          end="", flush=True)
        if progress:
            print()
    except (urllib.error.URLError, OSError) as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"download failed ({e}); this host may have no egress — place "
            f"the archive at {out} manually and rerun") from e
    os.replace(tmp, out)
    return out


def extract(archive, dest_dir) -> Path:
    """Extract zip/tar into `dest_dir`; skip when it already exists.
    Zip archives get one level of nested-zip extraction (the VCTK layout,
    preprocessing.py:46-54)."""
    archive, dest = Path(archive), Path(dest_dir)
    if dest.exists():
        print(f"dataset already extracted to {dest}")
        return dest
    tmp = dest.with_name(dest.name + ".extracting")
    if tmp.exists():
        # stale staging dir from a crashed/interrupted run: its partial
        # contents could defeat the single-top-dir collapse or leak stale
        # files into dest — always start from a clean slate
        import shutil
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    name = archive.name.lower()
    if name.endswith(".zip"):
        with zipfile.ZipFile(archive) as z:
            z.extractall(tmp)
        for inner in sorted(tmp.rglob("*.zip")):
            with zipfile.ZipFile(inner) as z:
                z.extractall(inner.parent)
    elif name.endswith((".tar", ".tar.bz2", ".tar.gz", ".tbz2", ".tgz")):
        with tarfile.open(archive) as t:
            t.extractall(tmp, filter="data")
    else:
        tmp.rmdir()
        raise ValueError(f"unsupported archive type: {archive}")
    # archives that already contain a single top dir matching dest keep it
    entries = list(tmp.iterdir())
    if len(entries) == 1 and entries[0].is_dir():
        os.replace(entries[0], dest)
        tmp.rmdir()
    else:
        os.replace(tmp, dest)
    print(f"extracted {archive.name} -> {dest}")
    return dest


def vctk_to_wavs(flacs_root, wavs_path, *, sr: int = 22050,
                 mic: str = "mic1", limit: Optional[int] = None) -> int:
    """Decode every `*_{mic}.flac` under `flacs_root` and write
    `<speaker>_<textnum>.wav` at `sr` into `wavs_path`
    (preprocessing.py:362-399; 22.05 kHz matches LJSpeech). The name drops
    the `_{mic}` suffix rather than truncating to 8 chars — the reference's
    `[:8]` mangles short speaker IDs like VCTK-0.92's 's5' ('s5_001_mic1' →
    's5_001_m'), which breaks text-id dedup downstream. Returns the number
    of files written."""
    from .audio import load_flac, resample, save_wav

    flacs_root, wavs = Path(flacs_root), Path(wavs_path)
    if wavs.exists():
        print(f"wavs path already exists: {wavs} (delete to regenerate)")
        return 0
    wavs.mkdir(parents=True)
    n = 0
    for flac in sorted(flacs_root.rglob(f"*_{mic}.flac")):
        audio, in_sr = load_flac(flac)
        if in_sr != sr:
            audio = resample(audio, in_sr, sr)
        stem = flac.stem.rsplit(f"_{mic}", 1)[0]
        save_wav(wavs / (stem + ".wav"), audio, sr)
        n += 1
        if limit is not None and n >= limit:
            break
    print(f"wrote {n} wavs @ {sr} Hz -> {wavs}")
    return n


def fetch_dataset(name: str, root=".", *, skip_download: bool = False) -> Path:
    """The preprocessing.py __main__ flow (:120-131): download + extract
    (+ VCTK wav conversion). Returns the extraction directory."""
    spec = DATASETS[name]
    root = Path(root)
    archive = root / spec["out_file"]
    if not skip_download:
        download(spec["url"], archive)
    dest = extract(archive, root / spec["extract_to"])
    if name == "VCTK":
        flacs = next(dest.rglob(spec["flacs_subdir"]), None)
        if flacs is None:
            raise FileNotFoundError(
                f"{spec['flacs_subdir']} not found under {dest}")
        vctk_to_wavs(flacs, dest / "wavs")
    return dest
