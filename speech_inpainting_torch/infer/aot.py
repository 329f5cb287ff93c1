"""AOT serving artifacts: the I_ea graph exported with `torch.export`,
weights included.

Counterpart of speech_inpainting_tpu/infer/aot.py. The whole serving
program of `InformedInpainter.batch` (mel frontend, HuBERT + head, centroid
splice, regrid, vocoder: `infer.inpaint.InpaintGraph`, the module the live
inpainter calls) is written as one exported program, so a serving process
runs it without the model sources, the converters or the checkpoints. Its
ResBlock1s are the operator `torch.ops.si.resblock1` (K1) or, behind a
plain `models/hifigan.py:Generator` override, `torch.ops.si.resblock_step`
(K2), so the loaded program launches the same CUDA kernels as the live
inpainter; loading needs only torch and this module's import of
ops/resblock.py, which registers them.

The batch dimension is symbolic when the graph allows it (one artifact for
every batch size); the mask position and length are inputs, so one
artifact also covers every mask. The utterance lengths are fixed.

Layout of an artifact directory:
    graph.pt2    torch.export.save of the exported graph and its weights
    meta.json    format, t22, t16, batch, poly, platforms (the device types
                 it loads on), exported_on, stored_on (the device type of
                 the stored weights) and, where the batch-polymorphic
                 export failed, poly_export_error

A program is stored on the device it was exported on, or on the CPU where
"cpu" is one of its platforms (weights stored on the card cannot be read
where there is none); loading onto another device type than the stored one
goes through `torch.export.passes.move_to_device_pass`.
"""
from __future__ import annotations

import json
from pathlib import Path

import torch
from torch.export.passes import move_to_device_pass

from ..device import full_f32, resolve_device, stage
from ..ops import resblock  # noqa: F401  (registers the si:: operators)

_FORMAT = 1
PLATFORMS = ("cuda", "cpu")


def _platforms(platforms, device: torch.device) -> list:
    plats = [device.type] if platforms is None else list(platforms)
    bad = [p for p in plats if p not in PLATFORMS]
    if bad:
        raise ValueError(
            f"an artifact of the PyTorch port loads on {list(PLATFORMS)}, "
            f"not {bad}: a TPU artifact is exported by the JAX package "
            "(speech_inpainting_tpu/infer/aot.py)")
    return plats


def _example(n: int, t22: int, t16: int, device) -> tuple:
    return (torch.zeros(n, t22, device=device),
            torch.zeros(n, t16, device=device),
            torch.zeros(n, dtype=torch.int64, device=device),
            torch.ones(n, dtype=torch.int64, device=device))


def export_serving_graph(inpainter, t22: int, t16: int, batch=None,
                         platforms=None, *, device=None):
    """Export `inpainter.graph` for utterances of t22 samples at 22.05 kHz
    and t16 at 16 kHz.

    batch=None exports with a symbolic batch dimension (any batch of at
    least 1); an int pins it. `platforms` lists the device types the
    artifact may be loaded on ("cuda", "cpu"; default the exporting
    device's). The export runs on `device` (the card unless "cpu" is
    passed), where the inpainter must lie. Returns (ExportedProgram, meta
    dict).
    """
    device = resolve_device(device)
    plats = _platforms(platforms, device)
    if inpainter.device != device:
        raise ValueError(f"the inpainter lies on {inpainter.device}, the "
                         f"export runs on {device}")
    poly = batch is None
    args = _example(2 if poly else batch, t22, t16, device)
    dynamic = None
    if poly:
        b = torch.export.Dim("b", min=1)
        dynamic = ({0: b},) * 4
    with torch.no_grad():
        ep = torch.export.export(inpainter.graph, args,
                                 dynamic_shapes=dynamic, strict=False)
    meta = {"format": _FORMAT, "t22": t22, "t16": t16, "batch": batch,
            "poly": poly, "platforms": plats, "exported_on": device.type,
            "stored_on": device.type}
    return ep, meta


def save_serving_artifact(path, inpainter, t22: int, t16: int, batch=None,
                          platforms=None, *, device=None) -> dict:
    """Write an artifact directory {graph.pt2, meta.json}. Tries the
    batch-polymorphic export first where no batch is given, and falls back
    to a static batch of 1, recording why in `poly_export_error`."""
    device = resolve_device(device)
    _platforms(platforms, device)
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    try:
        ep, meta = export_serving_graph(inpainter, t22, t16, batch,
                                        platforms, device=device)
    except Exception as e:
        if batch is not None:
            raise
        # the symbolic batch is best-effort (a shape guard of some
        # configuration may refuse it): record why the artifact is static
        print("aot: batch-polymorphic export failed "
              f"({type(e).__name__}: {e}); exporting static batch=1")
        ep, meta = export_serving_graph(inpainter, t22, t16, 1, platforms,
                                        device=device)
        meta["poly_export_error"] = f"{type(e).__name__}: {e}"[:500]
    if "cpu" in meta["platforms"] and meta["stored_on"] != "cpu":
        ep = move_to_device_pass(ep, "cpu")
        meta["stored_on"] = "cpu"
    torch.export.save(ep, path / "graph.pt2")
    (path / "meta.json").write_text(json.dumps(meta, indent=1))
    return meta


class ServingArtifact:
    """A loaded artifact: `.batch(wav22, wav16, mask_pos, mask_len)` as
    `InformedInpainter.batch` takes and returns them.

    Loads on `device` (the card unless "cpu" is passed), which must be one
    of the artifact's platforms; a program stored on another device type
    is moved there by `torch.export.passes.move_to_device_pass`.
    """

    def __init__(self, path, device=None):
        path = Path(path)
        self.device = resolve_device(device)
        self.meta = json.loads((path / "meta.json").read_text())
        if self.meta.get("format") != _FORMAT:
            raise ValueError(f"unknown artifact format: {self.meta}")
        if self.device.type not in self.meta["platforms"]:
            raise ValueError(f"artifact exported for {self.meta['platforms']}"
                             f", not {self.device.type}")
        ep = torch.export.load(path / "graph.pt2")
        if self.device.type != self.meta["stored_on"]:
            ep = move_to_device_pass(ep, self.device)
        self._program = ep.module()

    @torch.inference_mode()
    @full_f32()
    def batch(self, wav22, wav16, mask_pos, mask_len) -> dict:
        """wav22 (B, t22), wav16 (B, t16) float; mask_pos, mask_len (B,) in
        20 ms frames. Runs in full float32, as the live inpainter does (the
        exported program does not carry the TF32 flags)."""
        dev = self.device
        args = (stage(wav22, torch.float32, dev),
                stage(wav16, torch.float32, dev),
                stage(mask_pos, torch.int64, dev),
                stage(mask_len, torch.int64, dev))
        b = args[0].shape[0]
        if not self.meta["poly"] and b != self.meta["batch"]:
            raise ValueError(f"artifact exported for batch "
                             f"{self.meta['batch']}, got {b}")
        return self._program(*args)


def load_serving_artifact(path, device=None) -> ServingArtifact:
    return ServingArtifact(path, device)


__all__ = ["export_serving_graph", "save_serving_artifact",
           "load_serving_artifact", "ServingArtifact"]
