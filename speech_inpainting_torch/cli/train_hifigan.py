"""HiFi-GAN training on the card: the vanilla vocoder, the teacher-mel
fine-tune, or the centroid-substitution decoder fine-tune ("modified"),
and the iSTFT-head vocoder family by the vanilla recipe (`--istft`).

Counterpart of speech_inpainting_tpu/cli/train_hifigan.py, with its flags
and defaults:

  python -m speech_inpainting_torch.cli.train_hifigan \\
      --wavs DIR [--filelist F] --checkpoint-path ckpt/ \\
      [--modified --kmeans model.npy --mask-len 20 --segment-size 44288]
      [--istft]

The generator starts from the JAX package's init drawn from `--seed` (the
discriminators from seeds 1 and 2, as there), or from a reference `g_*`
file with `--warm-start`. Checkpoints go to `--checkpoint-path` as the
reference names them: `g_{step:08d}` (`{"generator": state_dict}`, which
`vocode --checkpoint` and `predict_ea --hifigan-checkpoint` read) and
`do_{step:08d}` (discriminators, optimizers, steps); a rerun resumes from
the newest, and `--epochs` counts the epochs of each run. The real and
fake batches run through the weight-normed discriminators as one forward
(`batched_disc`), as the JAX CLI sets it. `--istft` trains a
`WNISTFTGenerator` (the C8C8I trunk at the config's width, kernel sizes and
dilations, then the n_fft 16 / hop 4 iSTFT head) from `--seed`; its g_
holds that module's state dict, and its validation sweep folds it into
the inference `ISTFTGenerator` (trunk in K1 on the card). It takes neither
`--modified` nor `--warm-start`, as in the JAX CLI. Runs on the CUDA card;
`--device cpu` runs on the CPU. Not ported: the data-parallel flags
(`--mesh`, `--coordinator`, `--num-processes`, `--process-id`: ROADMAP
Queue 1 item 11), which are refused.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..convert.hifigan_torch import load_trainable_generator
from ..convert.from_jax import (trainable_generator,
                                trainable_istft_generator)
from ..data.audio import load_wav, peak_normalize
from ..device import resolve_device
from ..models.hifigan import HiFiGANConfig
from ..models.hifigan_istft import ISTFTGeneratorConfig
from ..ops.mel import MODIFIED_MEL_22K
from ..quantize.kmeans import KMeans
from ..train.gan import GANConfig, create_gan_state, default_discriminators
from ..train.hifigan import (HiFiGANTrainConfig, make_modified_eval,
                             make_modified_step, make_vanilla_eval,
                             make_vanilla_step, modified_gen_fwd,
                             vanilla_gen_fwd)
from ..train.run import RunConfig, gan_valid_fn, run_gan_training


class CropDataset:
    """Random fixed-length crops of normalized wavs (MelDataset's audio
    handling: /32768, peak ×0.95, a random segment); short utterances are
    zero-padded. `mels_dir` is the teacher-mel regime: the generator's
    input is `<mels_dir>/<stem>.npy`, the audio is not peak-normalized, and
    crops are mel-aligned (a random teacher-frame window, start in [0, F −
    fps − 1], with the matching audio slice; short ones padded). Batches
    equal the JAX package's bit for bit: one generator per epoch from
    SeedSequence([seed, epoch]), a permutation, then per item the crop
    start and after it the mask start."""

    def __init__(self, paths, segment_size: int, sr: int = 22050,
                 normalize: bool = True, mels_dir=None, hop: int = 256):
        self.segment_size = segment_size
        self.hop = hop
        self.wavs, self.mels = [], []
        for p in paths:
            wav, _ = load_wav(p, target_sr=sr)
            if normalize:
                wav = peak_normalize(wav, 0.95)
            self.wavs.append(wav.astype(np.float32))
            if mels_dir is not None:
                mel = np.load(Path(mels_dir) / f"{Path(p).stem}.npy")
                if mel.ndim == 3:          # (1, 80, F) dumps
                    mel = mel[0]
                self.mels.append(mel.astype(np.float32))
        if self.mels and segment_size % hop:
            raise ValueError("teacher-mel crops are hop-aligned; "
                             f"segment_size must be a multiple of hop {hop}")

    def _teacher_crop(self, rng, w, mel, seg):
        fps = seg // self.hop
        if len(w) >= seg and mel.shape[1] > fps:
            a = int(rng.integers(0, mel.shape[1] - fps))
            return (w[a * self.hop:a * self.hop + seg],
                    mel[:, a:a + fps])
        return (np.pad(w[:seg], (0, max(0, seg - len(w)))),
                np.pad(mel[:, :fps], ((0, 0), (0, max(0, fps - mel.shape[1])))))

    def batches(self, batch_size: int, *, epoch: int, seed: int = 1234,
                n441_mask_limit: int = 0):
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
        order = rng.permutation(len(self.wavs))
        seg = self.segment_size
        for s in range(0, len(order) - batch_size + 1, batch_size):
            crops, mels, starts = [], [], []
            for i in order[s:s + batch_size]:
                w = self.wavs[i]
                if self.mels:
                    crop, mel = self._teacher_crop(rng, w, self.mels[i], seg)
                    crops.append(crop)
                    mels.append(mel)
                elif len(w) >= seg:
                    a = int(rng.integers(0, len(w) - seg + 1))
                    crops.append(w[a:a + seg])
                else:
                    crops.append(np.pad(w, (0, seg - len(w))))
                if n441_mask_limit > 0:
                    starts.append(int(rng.integers(0, n441_mask_limit)))
            batch = {"audio": np.stack(crops)[:, None, :]}
            if mels:
                batch["mel"] = np.stack(mels)
            if starts:
                batch["mask_start"] = np.asarray(starts, np.int32)
            yield batch


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--wavs", required=True)
    p.add_argument("--filelist", default=None)
    p.add_argument("--valid-filelist", default=None,
                   help="held-out filelist for the periodic validation "
                        "mel-error sweep; deterministic crops, logged as "
                        "validation/mel_error")
    p.add_argument("--config", default=None, help="hifi-gan json config")
    p.add_argument("--checkpoint-path", required=True)
    p.add_argument("--log-dir", default=None)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--segment-size", type=int, default=None)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--modified", action="store_true")
    p.add_argument("--fine-tuning", action="store_true",
                   help="teacher-mel fine-tune: generator input mels come "
                        "from --input-mels-dir instead of the audio; audio "
                        "not peak-normalized")
    p.add_argument("--input-mels-dir", default=None,
                   help="dir of <stem>.npy teacher mels")
    p.add_argument("--istft", action="store_true",
                   help="train the iSTFT-head generator family (iSTFTNet "
                        "C8C8I trunk at the config's width) by the vanilla "
                        "recipe")
    p.add_argument("--kmeans", default=None)
    p.add_argument("--mask-len", type=int, default=20)
    p.add_argument("--warm-start", default=None,
                   help="reference g_* checkpoint to start the generator "
                        "from")
    p.add_argument("--skip-nonfinite", type=int, default=0, metavar="N",
                   help="never apply nan/inf-grad updates; abort (after "
                        "checkpointing) past N consecutive skips")
    p.add_argument("--bf16-disc", action="store_true",
                   help="discriminators compute in bf16 (parameters and "
                        "losses f32)")
    p.add_argument("--validation-interval", type=int, default=1000,
                   help="steps between validation sweeps")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: the CUDA card)")
    dist = p.add_argument_group("multi-host (not ported)")
    dist.add_argument("--mesh", action="store_true")
    dist.add_argument("--coordinator", default=None)
    dist.add_argument("--num-processes", type=int, default=None)
    dist.add_argument("--process-id", type=int, default=None)
    args = p.parse_args(argv)
    if args.mesh or args.coordinator or args.num_processes or \
            args.process_id is not None:
        p.error("--mesh and the multi-host flags are not ported: the "
                "PyTorch trainer runs one process on one device (ROADMAP "
                "Queue 1 item 11)")
    if args.istft and args.modified:
        p.error("--istft is a vanilla-recipe family")
    if args.istft and args.warm_start:
        p.error("--warm-start loads V1-architecture torch checkpoints; the "
                "iSTFT family trains fresh")
    if args.fine_tuning and args.modified:
        p.error("--fine-tuning is the teacher-mel vanilla recipe; "
                "--modified quantizes in-graph")
    if args.fine_tuning and not args.input_mels_dir:
        p.error("--fine-tuning requires --input-mels-dir")
    if args.modified and not args.kmeans:
        p.error("--modified requires --kmeans")
    device = resolve_device(args.device)

    h = json.loads(Path(args.config).read_text()) if args.config else {}
    gcfg = HiFiGANConfig.from_dict(h) if h else HiFiGANConfig()
    icfg = None
    if args.istft:
        icfg = ISTFTGeneratorConfig(
            upsample_initial_channel=gcfg.upsample_initial_channel,
            resblock_kernel_sizes=gcfg.resblock_kernel_sizes,
            resblock_dilation_sizes=gcfg.resblock_dilation_sizes,
            in_dim=gcfg.in_dim, sampling_rate=gcfg.sampling_rate,
            dtype=gcfg.dtype)
        if icfg.total_upsample != gcfg.total_upsample:
            p.error(f"the iSTFT geometry upsamples {icfg.total_upsample}x, "
                    f"the config's mel hop is {gcfg.total_upsample}: it "
                    "must keep the mel hop")
    seg = args.segment_size or h.get("segment_size",
                                     44288 if args.modified else 8192)
    tcfg = HiFiGANTrainConfig(
        gan=GANConfig(learning_rate=h.get("learning_rate", 2e-4),
                      adam_b1=h.get("adam_b1", 0.8),
                      adam_b2=h.get("adam_b2", 0.99),
                      lr_decay=h.get("lr_decay", 0.999),
                      batched_disc=True, disc_bf16=args.bf16_disc,
                      skip_nonfinite=args.skip_nonfinite),
        hifigan=gcfg, segment_size=seg, mask_len=args.mask_len)

    def filelist_paths(filelist):
        names = [l.strip().split("|")[0] for l in
                 Path(filelist).read_text().splitlines() if l.strip()]
        return [Path(args.wavs) / f"{n}.wav" for n in names]

    paths = (filelist_paths(args.filelist) if args.filelist
             else sorted(Path(args.wavs).glob("*.wav")))
    if args.fine_tuning:
        ds = CropDataset(paths, seg, normalize=False,
                         mels_dir=args.input_mels_dir,
                         hop=tcfg.mel_input.hop_size)
    else:
        ds = CropDataset(paths, seg)

    if args.modified:
        centroids = np.asarray(KMeans.load_auto(args.kmeans).centroids)
        step = make_modified_step(tcfg, centroids)
        n441 = max(1, MODIFIED_MEL_22K.num_frames(seg) - args.mask_len)
    else:
        step = make_vanilla_step(tcfg)
        n441 = 0

    if icfg is not None:
        gen = trainable_istft_generator(
            icfg, device=device,
            generator=torch.Generator().manual_seed(args.seed))
    elif args.warm_start:
        gen = load_trainable_generator(args.warm_start, gcfg, device=device)
        print(f"warm-started generator from {args.warm_start}")
    else:
        gen = trainable_generator(
            gcfg, device=device,
            generator=torch.Generator().manual_seed(args.seed))
    mpd, msd = default_discriminators(tcfg.gan, device)
    state = create_gan_state(tcfg.gan, gen, mpd, msd)

    run = RunConfig(epochs=args.epochs, checkpoint_dir=args.checkpoint_path,
                    log_dir=args.log_dir,
                    abort_nonfinite=args.skip_nonfinite,
                    validation_interval=args.validation_interval)
    valid_fn = None
    if args.valid_filelist:
        vds = CropDataset(
            filelist_paths(args.valid_filelist), seg,
            normalize=not args.fine_tuning,
            mels_dir=args.input_mels_dir if args.fine_tuning else None,
            hop=tcfg.mel_input.hop_size)
        # deterministic sweep: fixed epoch and seed, the same crops each time
        val_batches = list(vds.batches(
            min(args.batch_size, len(vds.wavs)), epoch=0,
            seed=args.seed + 1, n441_mask_limit=n441))
        if args.modified:
            ev = make_modified_eval(tcfg, centroids)
            fwd = modified_gen_fwd(tcfg, centroids)
        else:
            ev = make_vanilla_eval(tcfg)
            fwd = vanilla_gen_fwd(tcfg)
        valid_fn = gan_valid_fn(ev, val_batches, media_fwd=fwd,
                                media_mel=tcfg.mel_input,
                                sample_rate=gcfg.sampling_rate)
    return run_gan_training(
        step, state,
        lambda epoch: ds.batches(args.batch_size, epoch=epoch,
                                 seed=args.seed, n441_mask_limit=n441),
        run, valid_fn=valid_fn)


if __name__ == "__main__":
    main()
