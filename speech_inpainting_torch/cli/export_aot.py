"""Export an AOT serving artifact of the informed-inpainting graph.

Counterpart of speech_inpainting_tpu/cli/export_aot.py: loads the CLI's
checkpoints as `predict_ea` does (`predict_ea.load_inpainter`) and writes
a directory {graph.pt2, meta.json} holding the whole serving program of
`InformedInpainter.batch` exported with `torch.export`, weights included
(infer/aot.py). A serving process reloads it with
`infer.aot.load_serving_artifact(path).batch(...)`, without the model
sources or the checkpoints; batch-polymorphic where the graph allows it
(one artifact, any batch size), and the mask position and length are
inputs, so one artifact covers every mask.

    python -m speech_inpainting_torch.cli.export_aot --seconds 4 \\
        --hubert-checkpoint best.pt --hifigan-checkpoint g_02500000 \\
        --kmeans model.npy --out artifacts/inpaint_4s

Exports on the CUDA card; `--device cpu` exports on the CPU. `--platforms
cuda,cpu` lets the artifact load on either.
"""
from __future__ import annotations

import argparse

from ..device import resolve_device


def main(argv=None):
    from ..infer.aot import PLATFORMS, save_serving_artifact
    from .predict_ea import load_inpainter

    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--seconds", type=float, default=4.0,
                   help="utterance length the graph is exported for "
                        "(static lengths: one artifact per length)")
    p.add_argument("--batch", type=int, default=None,
                   help="pin a static batch size (default: polymorphic)")
    p.add_argument("--hubert-checkpoint", required=True)
    p.add_argument("--hubert-type", default="large",
                   choices=["base", "large"])
    p.add_argument("--hifigan-checkpoint", required=True)
    p.add_argument("--hifigan-config", default=None)
    p.add_argument("--kmeans", required=True)
    p.add_argument("--platforms", default=None,
                   help="comma-separated device types the artifact loads on "
                        f"({','.join(PLATFORMS)}); default: the exporting "
                        "device's")
    p.add_argument("--out", required=True, help="artifact directory")
    p.add_argument("--device", default="cuda",
                   help="torch device to export on (default: the CUDA card)")
    args = p.parse_args(argv)

    platforms = args.platforms.split(",") if args.platforms else None
    bad = sorted(set(platforms or ()) - set(PLATFORMS))
    if bad:
        p.error(f"--platforms {','.join(bad)}: the PyTorch port exports for "
                f"{','.join(PLATFORMS)}; a TPU artifact comes from "
                "speech_inpainting_tpu's export_aot")
    device = resolve_device(args.device)
    inp = load_inpainter(args)
    t22 = int(args.seconds * 22050)
    t16 = int(args.seconds * 16000)
    meta = save_serving_artifact(args.out, inp, t22, t16, batch=args.batch,
                                 platforms=platforms, device=device)
    kind = "batch-polymorphic" if meta["poly"] else f"batch={meta['batch']}"
    print(f"exported {kind} artifact for {args.seconds:g}s utterances "
          f"on platforms {meta['platforms']} -> {args.out}")
    return meta


if __name__ == "__main__":
    main()
