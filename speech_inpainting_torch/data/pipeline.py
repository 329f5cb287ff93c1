"""Host→device input pipeline: a background thread stages each batch on the
device ahead of the step that uses it.

Counterpart of speech_inpainting_tpu/data/pipeline.py's `device_prefetch`
on one device. On a CUDA device each batch goes through pinned memory,
copied with `non_blocking=True` on a stream of its own, so the copy
neither waits for the step running on the compute stream nor holds up the
host; the consumer's stream waits on the copy's event before it uses the
batch. A loader error reaches the consumer, as in the JAX package. Under a
mesh (parallel/mesh.py) the batches are this rank's rows of each global
batch, cut by `parallel.distributed.local_batches` before they get here
(JAX assembles the processes' rows into one global array here), and
`device` is this rank's; so the JAX function's `mesh` and `axis` have no
counterpart.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch


def device_prefetch(batches: Iterable, *, device) -> Iterator[dict]:
    """Iterate `batches` (dicts of numpy arrays), each staged as tensors on
    `device` ahead of use, at most two ahead."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if cuda else None

    def put(batch):
        host = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items()}
        if not cuda:
            return host, None
        with torch.cuda.stream(copy_stream):
            out = {k: v.pin_memory().to(device, non_blocking=True)
                   for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(copy_stream)
        return out, done

    q: "queue.Queue" = queue.Queue(maxsize=2)
    end = object()
    err = []

    def worker():
        try:
            for b in batches:
                q.put(put(b))
        except Exception as e:          # surface loader errors to the consumer
            err.append(e)
        finally:
            q.put(end)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            if err:
                raise err[0]
            return
        batch, done = item
        if done is not None:
            compute = torch.cuda.current_stream(device)
            compute.wait_event(done)
            for t in batch.values():   # freed only after the step's use
                t.record_stream(compute)
        yield batch
