"""I_da blind/informed inpainting of the utterances of a manifest, on the
card.

Counterpart of speech_inpainting_tpu/cli/inpaint_da.py (the reference's
I_da/scripts/inpainting.py): for each manifest wav × mask size (default
100, 200, 300 and 400 ms at 1.5 s) it writes {name}_gt and {name}_gen (at
the first mask only), {name}_masked_{ms} and {name}_inpainted_{ms}.wav, and
prints the median real-time factor.

  python -m speech_inpainting_torch.cli.inpaint_da \\
      --config configs/da_hubert100_lut.json --manifest val.txt \\
      --codegen-checkpoint g_00400000 --hubert hubert-base-ls960/ \\
      --layer 6 --kmeans km.npy --out outputs/

`--codegen-checkpoint` is the reference's CodeGenerator `g_*` file;
`--hubert` a local HF checkpoint directory (config.json and
pytorch_model.bin; hub names are not downloaded); `--kmeans` a .npy
codebook or a reference joblib model. Runs on the CUDA card;
`--device cpu` runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import numpy as np

from ..convert.hubert_torch import load_hf_pretrained
from ..convert.ida_torch import load_code_generator_checkpoint
from ..data.audio import load_wav, save_wav
from ..data.code_dataset import mel_stats_embedder
from ..data.manifests import parse_manifest
from ..infer.ida_inpaint import IdaInpainter
from ..models.codegen import CodeGeneratorConfig
from ..quantize.kmeans import KMeans

DEFAULT_MASKS_MS = (100, 200, 300, 400)


def main(argv=None) -> list:
    """The CLI; returns the real-time factor of each (file, mask) call."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--config", required=True)
    p.add_argument("--manifest", required=True)
    p.add_argument("--codegen-checkpoint", required=True,
                   help="the reference's CodeGenerator g_* file")
    p.add_argument("--hubert", required=True,
                   help="local HF checkpoint directory of the frozen encoder")
    p.add_argument("--layer", type=int, default=6,
                   help="feature tap layer (fairseq output_layer)")
    p.add_argument("--kmeans", required=True)
    p.add_argument("--mask-ms", type=int, nargs="+",
                   default=list(DEFAULT_MASKS_MS))
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the CUDA card)")
    args = p.parse_args(argv)

    h = json.loads(Path(args.config).read_text())
    ccfg = CodeGeneratorConfig.from_dict(h)
    codegen = load_code_generator_checkpoint(args.codegen_checkpoint, ccfg,
                                             device=args.device)
    hcfg, hubert = load_hf_pretrained(args.hubert, device=args.device)
    km = KMeans.load_auto(args.kmeans)
    inp = IdaInpainter(ccfg, None, None, hcfg, None, km.centroids,
                       tap_layer=args.layer,
                       code_hop=h.get("code_hop_size", 320), codegen=codegen,
                       hubert=hubert, device=args.device)
    embed = mel_stats_embedder(h.get("embedding_dim", 128),
                               device=args.device)

    files, _ = parse_manifest(args.manifest)
    out_dir = Path(args.out)
    os.makedirs(out_dir, exist_ok=True)
    sr = h.get("sampling_rate", 16000)
    rtfs = []
    for f in files:
        wav, _ = load_wav(f, target_sr=sr)
        name = Path(f).stem
        emb = embed(wav, sr)
        for ms in args.mask_ms:
            out = inp(wav, mask_size=ms * sr // 1000, emb=emb)
            wavs = {f"masked_{ms}": "audio_mask",
                    f"inpainted_{ms}": "audio_inpainted"}
            if ms == args.mask_ms[0]:
                wavs.update(gt="audio_gt", gen="audio_gen")
            for suffix, key in wavs.items():
                save_wav(out_dir / f"{name}_{suffix}.wav",
                         out[key].cpu().numpy(), sr)
            rtfs.append(out["rtf"])
    print(f"done: {len(files)} files x {len(args.mask_ms)} masks, "
          f"median RTF {np.median(rtfs):.4f} -> {args.out}")
    return rtfs


if __name__ == "__main__":
    main()
