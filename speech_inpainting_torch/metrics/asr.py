"""ASR-based WER/CER via Whisper (gated on model availability), the
counterpart of speech_inpainting_tpu/metrics/asr.py.

The reference transcribes with Whisper-small and scores WER/CER against the
target text (I_ea/metrics.py:80-119). Nothing is downloaded: the model
loads only from a local cache (`local_files_only=True`), and
`WhisperScorer.available()` is False when `transformers` cannot be imported
or no local cache holds the model, so the eval harness and the `score` CLI
report WER/CER only where one exists. `transformers` is imported inside
these functions and nowhere else in the port.

The model runs on the CUDA card unless `device="cpu"` is passed, as every
entry point of the port.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..data.audio import resample
from ..device import resolve_device
from .objective import cer, normalize_text, wer


class WhisperScorer:
    def __init__(self, model_name: str = "openai/whisper-small",
                 cache_dir: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        from transformers import (WhisperForConditionalGeneration,
                                  WhisperProcessor)
        self.processor = WhisperProcessor.from_pretrained(
            model_name, cache_dir=cache_dir, local_files_only=True)
        self.model = WhisperForConditionalGeneration.from_pretrained(
            model_name, cache_dir=cache_dir,
            local_files_only=True).to(self.device)
        self.model.config.forced_decoder_ids = \
            self.processor.get_decoder_prompt_ids(language="english",
                                                  task="transcribe")

    @staticmethod
    def available(model_name: str = "openai/whisper-small",
                  cache_dir: Optional[str] = None) -> bool:
        try:
            from transformers import WhisperProcessor
            WhisperProcessor.from_pretrained(model_name, cache_dir=cache_dir,
                                             local_files_only=True)
            return True
        except Exception:
            return False

    def transcribe(self, audio: np.ndarray, sr: int) -> str:
        if sr != 16000:
            audio = resample(np.asarray(audio, np.float32), sr, 16000)
        feats = self.processor(audio, sampling_rate=16000,
                               return_tensors="pt").input_features
        with torch.inference_mode():
            ids = self.model.generate(feats.to(self.device))
        text = self.processor.batch_decode(ids, skip_special_tokens=True)[0]
        return normalize_text(text)

    def wer_cer(self, audio: np.ndarray, sr: int, target_text: str
                ) -> Tuple[float, float, str]:
        hyp = self.transcribe(audio, sr)
        tgt = normalize_text(target_text)
        return wer(tgt, hyp, normalize=False), \
            cer(tgt, hyp, normalize=False), hyp
