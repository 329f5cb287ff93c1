"""Pipelined batch serving: at most `depth` batches in flight on the card.

Counterpart of speech_inpainting_tpu/infer/serving.py. PyTorch enqueues a
batch's work on the card's stream and returns; `PipelinedRunner` lets the
host stage batch N+1 … N+depth−1 while batch N runs, and waits for a batch
only when more than `depth` are in flight, so the card does not idle
between batches and at most `depth` batches' outputs are held. Results come
back in submission order.

One stream serves: a batch's work, and the copies that `fetch` enqueues for
it, run in order after the previous batch's. The completion barrier is a
CUDA event recorded on that stream right after them (`force`), never
`torch.cuda.synchronize()`, which would also wait for the batches
submitted later.

Usage::

    runner = PipelinedRunner(inpainter.batch, depth=4)
    for batch in batches:                 # numpy arrays are fine: `batch`
        for done in runner.submit(*batch):  # stages them through pinned
            consume(done)                   # memory without waiting
    for done in runner.drain():
        consume(done)
"""
from __future__ import annotations

import collections
import time
from typing import Any, Callable, Iterable, Iterator

import torch


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def _card(tree) -> torch.device | None:
    """The card that holds `tree`'s tensors, None when none lies on one."""
    return next((t.device for t in _tensors(tree) if t.device.type == "cuda"),
                None)


def _record(device: torch.device | None) -> torch.cuda.Event | None:
    """An event recorded on `device`'s current stream (None for no card):
    it completes when the work enqueued there so far is done."""
    if device is None:
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def force(tree, event: torch.cuda.Event | None = None):
    """Completion barrier: wait until the work that made `tree` is done, on
    `event` (recorded after it) or on one recorded now. The data stays
    where it is; returns `tree`."""
    event = _record(_card(tree)) if event is None else event
    if event is not None:
        event.synchronize()
    return tree


def to_host(tree):
    """Enqueue copies of `tree`'s card tensors into pinned host memory on
    the current stream (non-blocking) and return the host tree. The copies
    are valid once a barrier recorded after them has passed: as
    PipelinedRunner's `fetch`, the runner's own."""
    def copy(t):
        if t.device.type != "cuda":
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t, non_blocking=True)
    return _map(copy, tree)


class PipelinedRunner:
    """Bounded-depth pipelined executor around a batch function.

    fn: enqueues one batch on the card and returns its tensors (a tensor
        or a dict/list/tuple of them), e.g. `InformedInpainter.batch`.
    depth: most batches in flight before the oldest is waited for; depth 1
        is the per-batch synchronised loop.
    fetch: applied to each batch's result as it is submitted, on the same
        stream (so its copies follow the batch's work): the default leaves
        the result on the card; `to_host` brings it to pinned host memory.
        Either way the runner yields it after its barrier (`force` on an
        event recorded after fn and fetch).
    """

    def __init__(self, fn: Callable[..., Any], depth: int = 4,
                 fetch: Callable[[Any], Any] | None = None):
        assert depth >= 1, depth
        self._fn = fn
        self._depth = depth
        self._fetch = fetch
        self._inflight: collections.deque = collections.deque()
        self.submitted = 0
        self.completed = 0
        self._t0 = None

    def submit(self, *args, **kw) -> list:
        """Enqueue one batch; return the oldest result(s) once more than
        `depth` are in flight (so the steady state keeps exactly `depth`)."""
        if self._t0 is None:
            self._t0 = time.perf_counter()
        out = self._fn(*args, **kw)
        card = _card(out)
        if self._fetch is not None:
            out = self._fetch(out)
        self._inflight.append((out, _record(card)))
        self.submitted += 1
        ready = []
        while len(self._inflight) > self._depth:
            ready.append(self._complete())
        return ready

    def drain(self) -> list:
        """Wait for and return every result still in flight, oldest
        first."""
        ready = []
        while self._inflight:
            ready.append(self._complete())
        return ready

    def _complete(self):
        out, event = self._inflight.popleft()
        force(out, event)
        self.completed += 1
        return out

    def map(self, batches: Iterable[tuple]) -> Iterator[Any]:
        """Pipeline `fn` over an iterable of argument tuples, yielding the
        results in order."""
        for args in batches:
            yield from self.submit(*args)
        yield from self.drain()

    @property
    def elapsed(self) -> float:
        """Wall seconds since the first submit (0 before any)."""
        return 0.0 if self._t0 is None else time.perf_counter() - self._t0

    def throughput(self, units_per_batch: float) -> float:
        """Completed units per wall second (e.g. audio seconds per batch →
        audio-s/s); meaningful after a drain()."""
        t = self.elapsed
        return 0.0 if t == 0 else self.completed * units_per_batch / t


__all__ = ["PipelinedRunner", "force", "to_host"]
