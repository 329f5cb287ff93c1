"""ctypes bindings for the repository's native speechio library
(native/speechio.cc): its wav and FLAC decoders (for data/audio.py's
`load_flac`), its Kaiser polyphase resampler (`resample`) and its threaded
batch of random crops (`batch_crops`: decode, resample, peak-normalise and
crop in C++, the reference's DataLoader workers' host loop).

The port's own copy of speech_inpainting_tpu/data/native.py (the library
is the repository's, not the JAX package's). `build()` compiles it on
demand with the repository's Makefile (`make -C native`); `available()` is
False where that fails.
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libspeechio.so"
_lib: Optional[ctypes.CDLL] = None


def build(force: bool = False) -> bool:
    """Compile libspeechio.so (make's mtime check makes this a no-op when
    current — always invoking it avoids serving a stale .so after source
    edits). Returns availability."""
    try:
        cmd = ["make", "-C", str(_NATIVE_DIR)]
        if force:
            cmd.append("-B")
        subprocess.run(cmd, check=True, capture_output=True)
        return _LIB_PATH.exists()
    except Exception:
        return _LIB_PATH.exists() and not force


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists() and not build():
        return None
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.si_wav_info.argtypes = [ctypes.c_char_p,
                                ctypes.POINTER(ctypes.c_int),
                                ctypes.POINTER(ctypes.c_int64)]
    lib.si_flac_info.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_int),
                                 ctypes.POINTER(ctypes.c_int64)]
    lib.si_load_wav.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                ctypes.POINTER(ctypes.c_float),
                                ctypes.c_int64,
                                ctypes.POINTER(ctypes.c_int64)]
    lib.si_resample.argtypes = [ctypes.POINTER(ctypes.c_float),
                                ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                ctypes.POINTER(ctypes.c_float),
                                ctypes.c_int64,
                                ctypes.POINTER(ctypes.c_int64)]
    lib.si_batch_crops.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_float,
                                   ctypes.POINTER(ctypes.c_int64),
                                   ctypes.c_int64,
                                   ctypes.POINTER(ctypes.c_float)]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def wav_info(path):
    lib = _load()
    sr = ctypes.c_int()
    frames = ctypes.c_int64()
    rc = lib.si_wav_info(str(path).encode(), ctypes.byref(sr),
                         ctypes.byref(frames))
    if rc != 0:
        raise IOError(f"si_wav_info({path}) -> {rc}")
    return sr.value, frames.value


def flac_info(path):
    lib = _load()
    sr = ctypes.c_int()
    frames = ctypes.c_int64()
    rc = lib.si_flac_info(str(path).encode(), ctypes.byref(sr),
                          ctypes.byref(frames))
    if rc != 0:
        raise IOError(f"si_flac_info({path}) -> {rc}")
    return sr.value, frames.value


def load_wav(path, target_sr: Optional[int] = None):
    """Decode .wav or .flac (suffix dispatch in C) -> (float32 mono, sr)."""
    lib = _load()
    info = flac_info if str(path).lower().endswith(".flac") else wav_info
    sr, frames = info(path)
    if frames == 0:  # STREAMINFO may omit the total-sample count
        frames = Path(path).stat().st_size * 4
    tsr = target_sr or sr
    cap = int(frames * max(1.0, tsr / sr) + 16)
    n = ctypes.c_int64()
    while True:
        out = np.empty(cap, np.float32)
        rc = lib.si_load_wav(str(path).encode(), tsr if target_sr else 0,
                             _fp(out), cap, ctypes.byref(n))
        if rc == -3 and n.value > cap:
            # capacity estimate undershot (e.g. STREAMINFO omitted total
            # samples and the stream is highly compressible); the C side
            # reports the exact required length — reallocate and retry
            cap = int(n.value)
            continue
        if rc != 0:
            raise IOError(f"si_load_wav({path}) -> {rc}")
        return out[:n.value].copy(), tsr


def resample(wav: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """wav (T,) at `sr` → float32 at `target_sr` (Kaiser polyphase)."""
    lib = _load()
    wav = np.ascontiguousarray(wav, np.float32)
    cap = int(len(wav) * max(1.0, target_sr / sr) + 16)
    out = np.empty(cap, np.float32)
    n = ctypes.c_int64()
    rc = lib.si_resample(_fp(wav), len(wav), sr, target_sr, _fp(out), cap,
                         ctypes.byref(n))
    if rc != 0:
        raise IOError(f"si_resample -> {rc}")
    return out[:n.value].copy()


def batch_crops(paths: Sequence, starts: Sequence[int], crop_len: int,
                *, target_sr: int = 0, normalize_level: float = 0.95
                ) -> np.ndarray:
    """(n, crop_len) float32: each file decoded, resampled to `target_sr`
    (0 keeps its rate), peak-normalised to `normalize_level` and cropped
    from its start, on the library's threads."""
    lib = _load()
    n = len(paths)
    out = np.empty((n, crop_len), np.float32)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    st = np.ascontiguousarray(np.asarray(starts, np.int64))
    rc = lib.si_batch_crops(
        arr, n, target_sr, normalize_level,
        st.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        crop_len, _fp(out))
    if rc != 0:
        raise IOError(f"si_batch_crops -> {rc}")
    return out
