"""Checkpoint files with the JAX package's names and layout.

Counterpart of speech_inpainting_tpu/utils/checkpoints.py's
`scan_checkpoint`, `checkpoint_step` and `Checkpointer`, with `torch.save`
files in place of orbax directories (orbax is a JAX library):
  - `{prefix}{step:08d}` names, `scan_checkpoint(dir, prefix)` → the
    newest or None;
  - each file is written atomically (a temporary file, then `os.replace`),
    so an interrupted save never leaves a half-written checkpoint under a
    checkpoint's name;
  - saves are asynchronous, as orbax's are: the tree is copied to the host
    at once, and a thread writes it while training goes on; `wait()` joins
    the write and raises its error, `save(wait=True)` waits at once.
The GAN trainer's pair (`save_gan_checkpoint`, `restore_gan_checkpoint`):
`g_{step:08d}` is `{"generator": state_dict}`: a `WNGenerator`'s under the
reference's keys (legacy weight norm), which
`convert.hifigan_torch.load_generator_checkpoint` reads as it reads a
reference file (`vocode`, `predict_ea`), a `WNISTFTGenerator`'s under the
same keys (conv_post n_fft + 2 wide; `load_state_dict` into
`trainable_istft_generator(cfg)` reads it back), or a
`WNCodeGenerator`'s, whose EMA codebooks ride in it as buffers (JAX's g_
carries the `vq` collection beside the parameters); `do_{step:08d}` holds
the discriminators (the MSD's u/v among its buffers), both optimizers,
`steps`, with the nonfinite guard its counters and, where the state has
one, the restart candidates' generator state `rng` (JAX saves its PRNG key
there). The restore is
partial as in the JAX package: the newest `g_` and the newest `do_` are
each loaded where found.
"""
from __future__ import annotations

import os
import re
import threading
from pathlib import Path
from typing import Any, Optional

import torch


def scan_checkpoint(directory, prefix: str) -> Optional[str]:
    """Newest '{prefix}{step:08d}' entry under `directory`, or None."""
    d = Path(directory)
    if not d.is_dir():
        return None
    pat = re.compile(re.escape(prefix) + r"(\d{8})$")
    best = None
    for p in d.iterdir():
        m = pat.match(p.name)
        if m:
            step = int(m.group(1))
            if best is None or step > best[0]:
                best = (step, str(p))
    return best[1] if best else None


def checkpoint_step(path) -> int:
    m = re.search(r"(\d{8})$", str(path))
    return int(m.group(1)) if m else 0


def _to_host(tree: Any) -> Any:
    """`tree` with every tensor copied to the CPU (a copy also for a CPU
    tensor, so that later in-place updates do not reach the write)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


class Checkpointer:
    """`torch.save` checkpoints of any tree of tensors, numbers, strings,
    lists and dicts (a model's or an optimizer's state_dict) under
    `directory`."""

    def __init__(self, directory):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _write(self, tree, path: Path) -> None:
        tmp = path.with_name(f".{path.name}.tmp")
        try:
            torch.save(tree, tmp)
            os.replace(tmp, path)
        except Exception as e:  # raised by wait() on the caller's side
            tmp.unlink(missing_ok=True)
            self._error = e

    def save(self, prefix: str, step: int, tree: Any, *,
             wait: bool = False) -> str:
        path = self.dir / f"{prefix}{step:08d}"
        host = _to_host(tree)
        self.wait()                      # one write at a time, in order
        self._writer = threading.Thread(target=self._write,
                                        args=(host, path))
        self._writer.start()
        if wait:
            self.wait()
        return str(path)

    def restore(self, prefix: str) -> Optional[Any]:
        """The newest checkpoint of `prefix`, loaded on the CPU; None when
        there is none."""
        self.wait()
        path = scan_checkpoint(self.dir, prefix)
        if path is None:
            return None
        return torch.load(path, map_location="cpu", weights_only=True)

    def wait(self) -> None:
        """Join the pending write; raise its error, if it had one."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def save_gan_checkpoint(ckpt: Checkpointer, state, step: int, *,
                        wait: bool = False) -> None:
    """Write `state` (a train.gan.GANTrainState) as g_/do_ at `step`."""
    full = state.state_dict()
    ckpt.save("g_", step, {"generator": full["generator"]})
    do = {k: full[k] for k in ("mpd", "msd", "optim_g", "optim_d")}
    do["steps"] = full["step"]
    for key in ("guards", "rng"):
        if key in full:
            do[key] = full[key]
    ckpt.save("do_", step, do, wait=wait)


def restore_gan_checkpoint(ckpt: Checkpointer, state):
    """Resume `state` from the newest g_ and the newest do_, each where
    found (a generator-only or discriminator-only warm start). Returns
    (state, had_g, had_do)."""
    g = ckpt.restore("g_")
    if g is not None:
        state.generator.load_state_dict(g["generator"])
    do = ckpt.restore("do_")
    if do is not None:
        state.mpd.load_state_dict(do["mpd"])
        state.msd.load_state_dict(do["msd"])
        state.g_opt.load_state_dict(do["optim_g"])
        state.d_opt.load_state_dict(do["optim_d"])
        state.step = int(do["steps"])
        if state.g_guard is not None and "guards" in do:
            state.g_guard.load_state_dict(do["guards"]["g"])
            state.d_guard.load_state_dict(do["guards"]["d"])
        if state.rng is not None and "rng" in do:
            state.rng.set_state(do["rng"])
    return state, g is not None, do is not None
