"""Build the port's CUDA kernels with nvcc at first use; load them with ctypes.

Each source `csrc/<name>.cu` is plain CUDA C++ with an extern "C" interface
(no PyTorch headers). It compiles for sm_90a into
`build/speech_inpainting_torch/lib<name>-<hash>.so` under the repository
root, a directory that .gitignore lists; the hash covers the source and the
nvcc flags, so an edited source builds anew and an unchanged one loads as it
is. `library` loads each source once per process and keeps the handle.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "speech_inpainting_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> dict | None:
    """Compile csrc/<name>.cu unless its library is current. Returns
    {"seconds", "log"} when it compiled (`log` is nvcc's output, with
    ptxas's register and spill counts), else None. Raises with nvcc's
    output when the compile fails."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(CSRC_DIR / f"{name}.cu")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    return {"seconds": time.perf_counter() - t0, "log": proc.stdout}


_loaded: dict[str, ctypes.CDLL] = {}


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The library of csrc/<name>.cu, built first if it is stale. The first
    call in a process loads it and declares `signatures`, {function:
    (argtypes, restype)}, on it; later calls return the same handle."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return lib
