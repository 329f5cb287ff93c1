"""Kaldi binary ark/scp matrix I/O, written directly.

The port's own copy of speech_inpainting_tpu/utils/kaldi.py (numpy only;
the port imports nothing of the JAX package). It replaces the reference's
`save_dict_kaldimat` (I_da/src/utils.py:346-356), which shells out to
kaldi's `copy-feats` through `kaldi_io`, by the binary-matrix wire format:

    <key> ' ' \\0B <'FM '|'DM '> \\x04<int32 rows> \\x04<int32 cols> <data>

uncompressed (kaldi readers accept both). The scp index lines are
`<key> <ark_path>:<offset>`, the offset at the \\0B marker, where
`copy-feats` points them.
"""
from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Dict, Iterable, Tuple

import numpy as np

_TOKENS = {b"FM ": np.dtype("<f4"), b"DM ": np.dtype("<f8")}


def write_mats(mats: Iterable[Tuple[str, np.ndarray]], out_prefix) -> tuple:
    """Write `(key, 2-D matrix)` pairs to `<out_prefix>.ark` + `.scp`.

    float64 inputs keep double precision ('DM '); everything else is cast
    to float32 ('FM '), matching kaldi's default feature dtype.
    Returns (ark_path, scp_path).
    """
    ark = Path(str(out_prefix) + ".ark")
    scp = Path(str(out_prefix) + ".scp")
    ark.parent.mkdir(parents=True, exist_ok=True)
    with open(ark, "wb") as fa, open(scp, "w") as fs:
        for key, mat in mats:
            m = np.asarray(mat)
            if m.ndim != 2:
                raise ValueError(f"{key}: kaldi matrices are 2-D, "
                                 f"got shape {m.shape}")
            if " " in key or not key:
                raise ValueError(f"invalid kaldi key {key!r}")
            dt = np.dtype("<f8") if m.dtype == np.float64 else np.dtype("<f4")
            token = b"DM " if dt.itemsize == 8 else b"FM "
            fa.write(key.encode() + b" ")
            offset = fa.tell()
            fa.write(b"\0B" + token)
            fa.write(b"\x04" + struct.pack("<i", m.shape[0]))
            fa.write(b"\x04" + struct.pack("<i", m.shape[1]))
            fa.write(np.ascontiguousarray(m, dtype=dt).tobytes())
            fs.write(f"{key} {ark}:{offset}\n")
    return ark, scp


def _read_mat_at(f) -> np.ndarray:
    marker = f.read(2)
    if marker != b"\0B":
        raise ValueError("not a kaldi binary matrix (missing \\0B marker); "
                         "text-mode arks are not supported")
    token = f.read(3)
    if token not in _TOKENS:
        raise ValueError(f"unsupported kaldi token {token!r} "
                         "(only uncompressed FM/DM matrices)")
    dt = _TOKENS[token]
    dims = []
    for _ in range(2):
        size = f.read(1)
        if size != b"\x04":
            raise ValueError("unexpected dimension int size")
        dims.append(struct.unpack("<i", f.read(4))[0])
    rows, cols = dims
    data = np.frombuffer(f.read(rows * cols * dt.itemsize), dtype=dt)
    return data.reshape(rows, cols)


def read_ark(ark_path) -> Dict[str, np.ndarray]:
    """Sequentially read every (key, matrix) from a binary ark."""
    out = {}
    with open(ark_path, "rb") as f:
        while True:
            key = bytearray()
            while True:
                c = f.read(1)
                if not c:
                    return out
                if c == b" ":
                    break
                key += c
            out[key.decode()] = _read_mat_at(f)


def read_scp(scp_path) -> Dict[str, np.ndarray]:
    """Random-access read via an scp index (`key path:offset` lines).
    Ark file handles are cached per path — one open per ark, not per
    utterance."""
    out = {}
    handles: Dict[str, Any] = {}
    try:
        with open(scp_path) as fs:
            for line in fs:
                line = line.strip()
                if not line:
                    continue
                key, loc = line.split(" ", 1)
                path, offset = loc.rsplit(":", 1)
                f = handles.get(path)
                if f is None:
                    f = handles[path] = open(path, "rb")
                f.seek(int(offset))
                out[key] = _read_mat_at(f)
    finally:
        for f in handles.values():
            f.close()
    return out
