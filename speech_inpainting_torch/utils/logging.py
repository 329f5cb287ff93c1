"""Training observability: stdout lines, TensorBoard scalars, audio and
mel figures.

Counterpart of speech_inpainting_tpu/utils/logging.py's `TrainLogger`: the
same stdout line (`Steps: N, k: v.vvv, …, s/b: x.xxx`, the reference's
per-step loss lines and seconds per batch), and TensorBoard scalars where
tensorboardX imports. Reading a metric that lies on the card waits for it,
so lines and scalars are read only at their intervals. `audio` writes the
validation waveform as a TensorBoard audio summary of scipy's WAV encoding
(tensorboardX's own add_audio needs soundfile); `mel_figure` writes a
spectrogram figure only where matplotlib imports.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np


class TrainLogger:
    def __init__(self, log_dir: Optional[str] = None, *,
                 stdout_interval: int = 5, summary_interval: int = 100,
                 quiet: bool = False):
        """quiet=True silences everything (the ranks other than the
        coordinator in a multi-process run)."""
        self.stdout_interval = stdout_interval
        self.summary_interval = summary_interval
        self.quiet = quiet
        self._writer = None
        if log_dir is not None and not quiet:
            try:
                from tensorboardX import SummaryWriter
                self._writer = SummaryWriter(log_dir)
            except ImportError:
                pass
        self._t_last = time.perf_counter()

    def step(self, step: int, metrics: Dict, *, prefix: str = "training"):
        now = time.perf_counter()
        if step % self.stdout_interval == 0 and not self.quiet:
            spb = now - self._t_last
            line = ", ".join(f"{k}: {float(v):4.3f}" for k, v in
                             metrics.items())
            print(f"Steps: {step}, {line}, s/b: {spb:4.3f}", flush=True)
        self._t_last = now
        if self._writer and step % self.summary_interval == 0:
            for k, v in metrics.items():
                self._writer.add_scalar(f"{prefix}/{k}", float(v), step)

    @property
    def writes(self) -> bool:
        """A TensorBoard writer exists: audio and figures are worth making."""
        return self._writer is not None

    def scalar(self, tag: str, value: float, step: int):
        if self._writer:
            self._writer.add_scalar(tag, float(value), step)

    def audio(self, tag: str, wav: np.ndarray, step: int, sr: int):
        if not self._writer:
            return
        import io
        from scipy.io import wavfile
        from tensorboardX.proto.summary_pb2 import Summary
        pcm = np.clip(np.asarray(wav, np.float32).reshape(-1), -1.0, 1.0)
        buf = io.BytesIO()
        wavfile.write(buf, sr, (pcm * 32767.0).astype(np.int16))
        a = Summary.Audio(sample_rate=sr, num_channels=1,
                          length_frames=len(pcm),
                          encoded_audio_string=buf.getvalue(),
                          content_type="audio/wav")
        self._writer._get_file_writer().add_summary(
            Summary(value=[Summary.Value(tag=tag, audio=a)]), step)

    def mel_figure(self, tag: str, mel: np.ndarray, step: int):
        """Spectrogram figure (the reference's plot_spectrogram panels)."""
        if not self._writer:
            return
        try:
            import matplotlib
        except ImportError:
            return
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(10, 4))
        im = ax.imshow(np.asarray(mel), aspect="auto", origin="lower",
                       interpolation="none")
        fig.colorbar(im, ax=ax)
        self._writer.add_figure(tag, fig, step)
        plt.close(fig)

    def close(self):
        if self._writer:
            self._writer.close()
