"""Nonfinite-update guard: a nan/inf gradient update is never applied.

Counterpart of speech_inpainting_tpu/train/guard.py's `all_finite` and
`skip_if_nonfinite`: a nonfinite gradient skips the whole update (the
parameters, both AdamW moments and its step count stay as they were) and
counts the consecutive and the total skips, which the training loop reads
to abort loudly once the streak passes its budget (`train/run.py`,
`RunConfig.abort_nonfinite`). `tree_if_finite` gates state that updates
outside an optimizer (the EMA codebooks, which update inside the
generator's forward) on that state's own finiteness.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch


def total_norm(tensors: Sequence[torch.Tensor],
               norm_type: float = 2.0) -> torch.Tensor:
    """torch.nn.utils.get_total_norm, also over tensors of which some are
    DTensors (parallel/tp.py's sharded weights): their norms are taken
    over the whole tensor (a collective over their mesh) and combined with
    the plain tensors' norm."""
    plain = [t for t in tensors if not hasattr(t, "full_tensor")]
    split = [t for t in tensors if hasattr(t, "full_tensor")]
    if not split:
        return torch.nn.utils.get_total_norm(plain, norm_type=norm_type)
    norms = [torch.linalg.vector_norm(t, norm_type).full_tensor()
             for t in split]
    if plain:
        norms.append(torch.nn.utils.get_total_norm(plain,
                                                   norm_type=norm_type))
    return torch.linalg.vector_norm(torch.stack(norms), norm_type)


def all_finite(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """0-dim bool tensor: no element of `tensors` is nan or inf (their
    largest magnitude is finite, which no sum can overflow)."""
    tensors = [t for t in tensors if t is not None]
    if not tensors:
        return torch.tensor(True)
    return torch.isfinite(total_norm(tensors, norm_type=float("inf")))


class SkipNonFinite:
    """The skip wrapper and its state (JAX's `SkipNonFiniteState`):
    `notfinite_count` consecutive skipped updates, `total_notfinite` all of
    them."""

    def __init__(self):
        self.notfinite_count = 0
        self.total_notfinite = 0

    def __call__(self, grads: Sequence[torch.Tensor],
                 update: Callable[[], None]) -> None:
        """Run `update` when every gradient is finite; else skip it and
        count. Reads one flag from the device."""
        if bool(all_finite(grads)):
            update()
            self.notfinite_count = 0
        else:
            self.notfinite_count += 1
            self.total_notfinite += 1

    def state_dict(self) -> dict:
        return {"notfinite_count": self.notfinite_count,
                "total_notfinite": self.total_notfinite}

    def load_state_dict(self, sd: dict) -> None:
        self.notfinite_count = int(sd["notfinite_count"])
        self.total_notfinite = int(sd["total_notfinite"])


@torch.no_grad()
def tree_if_finite(new: Sequence[torch.Tensor],
                   old: Sequence[torch.Tensor]) -> None:
    """JAX's `tree_if_finite(new, old)` on tensors updated in place: `new`
    (module buffers after an update) keep their values if every element of
    their floating-point ones is finite, else each takes back its copy in
    `old` (taken before the update). The choice is made on the device (no
    host read)."""
    if not new:
        return
    ok = all_finite([t for t in new if t.is_floating_point()]).to(
        new[0].device)
    for n, o in zip(new, old):
        n.copy_(torch.where(ok, n, o))
