"""Training observability: stdout lines and TensorBoard scalars.

Counterpart of speech_inpainting_tpu/utils/logging.py's `TrainLogger`: the
same stdout line (`Steps: N, k: v.vvv, …, s/b: x.xxx`, the reference's
per-step loss lines and seconds per batch), and TensorBoard scalars where
tensorboardX imports. Reading a metric that lies on the card waits for it,
so lines and scalars are read only at their intervals. `audio` and
`mel_figure` wait for GAN training.
"""
from __future__ import annotations

import time
from typing import Dict, Optional


class TrainLogger:
    def __init__(self, log_dir: Optional[str] = None, *,
                 stdout_interval: int = 5, summary_interval: int = 100):
        self.stdout_interval = stdout_interval
        self.summary_interval = summary_interval
        self._writer = None
        if log_dir is not None:
            try:
                from tensorboardX import SummaryWriter
                self._writer = SummaryWriter(log_dir)
            except ImportError:
                pass
        self._t_last = time.perf_counter()

    def step(self, step: int, metrics: Dict, *, prefix: str = "training"):
        now = time.perf_counter()
        if step % self.stdout_interval == 0:
            spb = now - self._t_last
            line = ", ".join(f"{k}: {float(v):4.3f}" for k, v in
                             metrics.items())
            print(f"Steps: {step}, {line}, s/b: {spb:4.3f}", flush=True)
        self._t_last = now
        if self._writer and step % self.summary_interval == 0:
            for k, v in metrics.items():
                self._writer.add_scalar(f"{prefix}/{k}", float(v), step)

    def scalar(self, tag: str, value: float, step: int):
        if self._writer:
            self._writer.add_scalar(tag, float(value), step)

    def close(self):
        if self._writer:
            self._writer.close()
