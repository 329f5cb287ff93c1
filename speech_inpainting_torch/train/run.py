"""The I_ea training loop: epochs × batches around the train step, with
logging, interval validation, checkpoints and resume.

Counterpart of speech_inpainting_tpu/train/run.py's `RunConfig`,
`PreemptionGuard`, `_check_nonfinite_abort` and `run_ea_training`, in one
process on one device: full-state resume from the newest `ea_`, validation
every `validation_interval` steps with `best_` on the highest
`cos_sim_acc`, `last_` at each epoch's end, the step cap, and SIGTERM or
SIGINT saving `ea_` and returning. `--epochs` counts the epochs of this
run, a resumed one too. A mesh (data parallel over several cards) is
refused: it waits for ROADMAP Queue 1 item 11. `run_gan_training` and
`gan_valid_fn` wait for GAN training.
"""
from __future__ import annotations

import dataclasses
import signal
import threading
from typing import Callable, Optional

import numpy as np

from ..data.pipeline import device_prefetch
from ..utils.checkpoints import Checkpointer
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
    mesh: Optional[object] = None          # not ported: must stay None
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


def run_ea_training(step_fn: Callable, eval_fn: Callable, state,
                    make_batches: Callable, make_valid_batches: Callable,
                    run: RunConfig):
    """Drive an `EATrainState`: step_fn(state, batch), eval_fn(model,
    batch), make_batches(epoch) / make_valid_batches(epoch) → iterables of
    host batches. Returns the final state."""
    if run.mesh is not None:
        raise NotImplementedError(
            "training over a mesh is not ported (ROADMAP Queue 1 item 11)")
    ckpt = Checkpointer(run.checkpoint_dir)
    logger = TrainLogger(run.log_dir, stdout_interval=run.stdout_interval,
                         summary_interval=run.summary_interval)
    full = ckpt.restore("ea_")
    if full is not None:
        state.load_state_dict(full)
        print(f"resumed from step {state.step}")
    device = next(state.model.parameters()).device
    model_tree = lambda: {"model": state.model.state_dict()}  # noqa: E731
    best_acc = -np.inf
    steps = state.step
    with PreemptionGuard() as pre:
        for epoch in range(run.epochs):
            for batch in device_prefetch(make_batches(epoch), device=device):
                state, metrics = step_fn(state, batch)
                steps += 1
                logger.step(steps, metrics)
                _check_nonfinite_abort(
                    run, steps, metrics,
                    lambda: ckpt.save("ea_", steps, state.state_dict(),
                                      wait=True))
                if pre.requested:
                    ckpt.save("ea_", steps, state.state_dict(), wait=True)
                    print(f"preempted: saved ea_ at step {steps}")
                    logger.close()
                    return state
                if steps % run.checkpoint_interval == 0:
                    ckpt.save("ea_", steps, state.state_dict())
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
                            ckpt.save("best_", 0, model_tree())
                if run.training_steps and steps >= run.training_steps:
                    break
            else:
                ckpt.save("last_", 0, model_tree())
                continue
            break
    ckpt.save("ea_", steps, state.state_dict())
    ckpt.save("last_", 0, model_tree(), wait=True)
    logger.close()
    return state
