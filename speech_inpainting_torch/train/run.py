"""The training loops: epochs × batches around a train step, with logging,
interval validation, checkpoints and resume.

Counterpart of speech_inpainting_tpu/train/run.py's `RunConfig`,
`PreemptionGuard`, `_check_nonfinite_abort`, `run_ea_training`,
`gan_valid_fn` and `run_gan_training`:
  - I_ea: full-state resume from the newest `ea_`, validation every
    `validation_interval` steps with `best_` on the highest `cos_sim_acc`,
    `last_` at each epoch's end;
  - GAN: resume from the newest `g_` and `do_` (either alone too),
    validation sweeps (mean mel error over fixed batches, and the first
    item's audio and mel figure where a TensorBoard writer exists), `g_`/
    `do_` every `checkpoint_interval` steps and at the end;
  - both: the step cap, the nonfinite abort (which saves first), and
    SIGTERM or SIGINT saving and returning. `--epochs` counts the epochs
    of this run, a resumed one too.
With `RunConfig.mesh` (parallel/mesh.py: one rank per card) the state is
restored, then made rank 0's on every rank (`sync_from_coordinator`), and
the step runs on the mesh (`state.mesh`: it reduces the gradients over the
data axes); each rank keeps its rows of every global batch
(`local_batches`), and only the coordinator writes checkpoints, log lines
and TensorBoard media. A validation sweep runs whole on every rank (its
batches replicated), so every rank logs the same means. Several processes
without a mesh raise: each would train a model of its own.
"""
from __future__ import annotations

import dataclasses
import signal
import threading
from typing import Callable, Optional

import numpy as np

from ..data.pipeline import device_prefetch
from ..parallel.distributed import (is_coordinator, local_batches,
                                    sync_from_coordinator)
from ..parallel.mesh import world_size
from ..utils.checkpoints import (Checkpointer, restore_gan_checkpoint,
                                 save_gan_checkpoint)
from ..utils.logging import TrainLogger


@dataclasses.dataclass
class RunConfig:
    epochs: int = 100
    checkpoint_dir: str = "checkpoints"
    log_dir: Optional[str] = None
    stdout_interval: int = 5
    summary_interval: int = 100
    checkpoint_interval: int = 5000
    validation_interval: int = 1000
    training_steps: Optional[int] = None   # hard step cap
    mesh: Optional[object] = None          # DeviceMesh for data
                                           # parallelism (parallel/mesh.py)
    abort_nonfinite: int = 0               # >0: abort (after checkpointing
                                           # the still-finite state) once the
                                           # step metric 'nonfinite_skips'
                                           # exceeds this at a
                                           # stdout_interval boundary


class PreemptionGuard:
    """SIGTERM/SIGINT → checkpoint-and-exit at the next step boundary.
    Installs handlers only in the main thread (the signal module's rule);
    elsewhere it is inert. The caller's handlers come back on exit."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.requested = False
        self._signals = signals
        self._prev = {}

    def _on(self, signum, frame):
        self.requested = True

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            for s in self._signals:
                self._prev[s] = signal.signal(s, self._on)
        return self

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            signal.signal(s, h)
        return False


def _check_nonfinite_abort(run: RunConfig, steps: int, metrics,
                           save_fn: Callable):
    """Abort the run loudly when the guard's consecutive-skip counter
    (metrics['nonfinite_skips'], from steps built with skip_nonfinite > 0)
    exceeds the budget, checked at stdout_interval boundaries. The guard
    never applied a nonfinite update, so the state is still clean:
    checkpoint it, then raise."""
    if not run.abort_nonfinite or steps % run.stdout_interval:
        return
    skips = metrics.get("nonfinite_skips")
    if skips is None or int(skips) <= run.abort_nonfinite:
        return
    save_fn()
    raise RuntimeError(
        f"aborting at step {steps}: {int(skips)} consecutive updates had "
        f"nonfinite grads (> budget {run.abort_nonfinite}); none were "
        "applied — the saved checkpoint is finite. Inspect the data/lr.")


def _place(state, run: RunConfig):
    """The restored state, rank 0's on every rank, running on run.mesh.
    Several processes without a mesh raise (no gradient reduction: each
    would silently train a divergent model)."""
    if run.mesh is None:
        if world_size() > 1:
            raise RuntimeError(
                "multi-process runtime with RunConfig.mesh=None: each "
                "process would silently train a divergent model (no "
                "gradient reduction). Build a global mesh "
                "(parallel.mesh.make_mesh / make_hybrid_mesh) and set "
                "RunConfig.mesh — the CLIs do this via --mesh.")
        return state
    state = sync_from_coordinator(state)
    state.mesh = run.mesh
    return state


def gan_valid_fn(eval_fn: Callable, val_batches,
                 media_fwd: Optional[Callable] = None,
                 media_mel=None, sample_rate: Optional[int] = None):
    """run_gan_training's valid_fn from a make_gan_eval product:
    valid_fn(state, logger=None, steps=0) → the per-metric means of
    eval_fn over `val_batches` (host batches). The state's generator is
    folded once per sweep by its own `fold()`, off autograd (a
    `WNGenerator` into a `Generator` and a `WNCodeGenerator` into a
    `CodeGenerator`, whose ResBlock1s run in K2 on the card; a
    `WNISTFTGenerator` into an `ISTFTGenerator`, whose trunk runs in K1).
    The folded module carries every codebook of the trained one, so the
    JAX package's `params_fn` (which hands the eval the `vq` leg beside
    the parameters) has no counterpart here. `media_fwd` (the eval's
    generator_fwd) logs the first validation item's audio (at
    `sample_rate`) and, with `media_mel` (a MelConfig), its mel figure,
    where the logger has a TensorBoard writer (without one the JAX package
    runs that forward for nothing). On a mesh every rank sweeps every
    batch (the JAX package replicates them), so the means agree; only the
    coordinator's logger writes."""
    import torch

    from ..ops.mel import mel_spectrogram

    def valid_fn(state, logger=None, steps: int = 0):
        gen = state.generator
        if hasattr(gen, "fold"):
            gen = gen.fold()
        vals = [eval_fn(gen, b) for b in val_batches]
        if media_fwd is not None and logger is not None and \
                logger.writes and val_batches:
            device = next(gen.parameters()).device
            b0 = {k: torch.as_tensor(v, device=device)
                  for k, v in val_batches[0].items()}
            with torch.no_grad():
                out = media_fwd(gen, b0)
            y = out[0] if isinstance(out, tuple) else out
            wav = y[0, 0].float().cpu()
            logger.audio("validation/audio", wav.numpy(), steps,
                         sample_rate or 22050)
            if media_mel is not None:
                logger.mel_figure("validation/mel", mel_spectrogram(
                    wav[None], media_mel)[0].numpy(), steps)
        if not vals:
            return {}
        return {k: float(np.mean([float(v[k]) for v in vals]))
                for k in vals[0]}

    return valid_fn


def run_gan_training(step_fn: Callable, state, make_batches: Callable,
                     run: RunConfig, *, valid_fn: Optional[Callable] = None):
    """Drive a `GANTrainState`: step_fn(state, batch), make_batches(epoch)
    → iterable of host batches, valid_fn(state, logger=, steps=) (as
    gan_valid_fn builds it) → metrics. Returns the final state."""
    coord = is_coordinator()
    ckpt = Checkpointer(run.checkpoint_dir)
    state, had_g, had_do = restore_gan_checkpoint(ckpt, state)
    state = _place(state, run)
    if (had_g or had_do) and coord:
        print(f"resumed from step {state.step}")
    logger = TrainLogger(run.log_dir, stdout_interval=run.stdout_interval,
                         summary_interval=run.summary_interval,
                         quiet=not coord)
    device = next(state.generator.parameters()).device
    steps = state.step

    def save(wait):
        if coord:
            save_gan_checkpoint(ckpt, state, steps, wait=wait)

    with PreemptionGuard() as pre:
        for epoch in range(run.epochs):
            for batch in device_prefetch(
                    local_batches(make_batches(epoch), run.mesh),
                    device=device):
                state, metrics = step_fn(state, batch)
                steps += 1
                logger.step(steps, metrics)
                _check_nonfinite_abort(run, steps, metrics,
                                       lambda: save(True))
                if pre.requested:
                    save(True)
                    if coord:
                        print(f"preempted: saved g_/do_ at step {steps}")
                    logger.close()
                    return state
                if steps % run.checkpoint_interval == 0:
                    save(False)
                if valid_fn is not None and \
                        steps % run.validation_interval == 0:
                    val = valid_fn(state, logger=logger, steps=steps)
                    for k, v in val.items():
                        logger.scalar(f"validation/{k}", v, steps)
                if run.training_steps and steps >= run.training_steps:
                    break
            else:
                continue
            break
    save(True)
    logger.close()
    return state


def run_ea_training(step_fn: Callable, eval_fn: Callable, state,
                    make_batches: Callable, make_valid_batches: Callable,
                    run: RunConfig):
    """Drive an `EATrainState`: step_fn(state, batch), eval_fn(model,
    batch), make_batches(epoch) / make_valid_batches(epoch) → iterables of
    host batches. Returns the final state."""
    coord = is_coordinator()
    ckpt = Checkpointer(run.checkpoint_dir)
    logger = TrainLogger(run.log_dir, stdout_interval=run.stdout_interval,
                         summary_interval=run.summary_interval,
                         quiet=not coord)
    full = ckpt.restore("ea_")
    if full is not None:
        state.load_state_dict(full)
        if coord:
            print(f"resumed from step {state.step}")
    state = _place(state, run)
    device = next(state.model.parameters()).device
    model_tree = lambda: {"model": state.model.state_dict()}  # noqa: E731

    def save(prefix, step, tree, wait=False):
        if coord:
            ckpt.save(prefix, step, tree, wait=wait)

    best_acc = -np.inf
    steps = state.step
    with PreemptionGuard() as pre:
        for epoch in range(run.epochs):
            for batch in device_prefetch(
                    local_batches(make_batches(epoch), run.mesh),
                    device=device):
                state, metrics = step_fn(state, batch)
                steps += 1
                logger.step(steps, metrics)
                _check_nonfinite_abort(
                    run, steps, metrics,
                    lambda: save("ea_", steps, state.state_dict(),
                                 wait=True))
                if pre.requested:
                    save("ea_", steps, state.state_dict(), wait=True)
                    if coord:
                        print(f"preempted: saved ea_ at step {steps}")
                    logger.close()
                    return state
                if steps % run.checkpoint_interval == 0:
                    save("ea_", steps, state.state_dict())
                if steps % run.validation_interval == 0:
                    vals = [eval_fn(state.model, vb)
                            for vb in make_valid_batches(epoch)]
                    if vals:
                        mean = {k: float(np.mean([float(v[k]) for v in vals]))
                                for k in vals[0]}
                        for k, v in mean.items():
                            logger.scalar(f"validation/{k}", v, steps)
                        if mean.get("cos_sim_acc", -np.inf) > best_acc:
                            best_acc = mean["cos_sim_acc"]
                            save("best_", 0, model_tree())
                if run.training_steps and steps >= run.training_steps:
                    break
            else:
                save("last_", 0, model_tree())
                continue
            break
    save("ea_", steps, state.state_dict())
    save("last_", 0, model_tree(), wait=True)
    logger.close()
    return state
