"""Text in, waveform out (port of ``parler_tts_tpu/pipeline.py``).

``ParlerTTSPipeline.tts(descriptions, prompts)`` tokenizes, pads to length
buckets (descriptions on the right, prompts on the LEFT), generates and
trims each waveform to its valid length.  Any tokenizer with the HF call
shape works: ``tok(list_of_str, padding=True, return_tensors="np")`` giving
``.input_ids`` and ``.attention_mask``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from parler_tts_tpu_torch.core.config import GenerationConfig, ParlerTTSConfig
from parler_tts_tpu_torch.core.device import resolve_device
from parler_tts_tpu_torch.generation.generate import generate
from parler_tts_tpu_torch.models.parler import ParlerTTSModel


def _bucket(n: int, sizes=(16, 32, 64, 128, 256)) -> int:
    for s in sizes:
        if n <= s:
            return s
    return ((n + 63) // 64) * 64


@dataclasses.dataclass
class ParlerTTSPipeline:
    """``model`` is moved to ``device`` and cast to ``dtype`` in place.
    ``pcm16=True`` returns int16 waveforms, the truncating cast a WAV body
    holds, instead of float32 in [-1, 1]."""

    model: ParlerTTSModel
    cfg: ParlerTTSConfig
    gen: GenerationConfig
    description_tokenizer: Any = None
    prompt_tokenizer: Any = None
    dtype: torch.dtype = torch.bfloat16
    pcm16: bool = False
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.model = self.model.to(device=self.device, dtype=self.dtype)

    def tts(self, description: str | list[str], prompt: str | list[str], *, seed: int = 0,
            max_seconds: float | None = None) -> tuple[int, list[np.ndarray]]:
        """-> (sampling_rate, [waveform per sample]).  ``seed`` seeds the
        sampler's ``torch.Generator``."""
        if self.description_tokenizer is None or self.prompt_tokenizer is None:
            raise RuntimeError("the pipeline needs a description and a prompt tokenizer")
        descs = [description] if isinstance(description, str) else list(description)
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        if len(descs) != len(prompts):
            raise ValueError(f"{len(descs)} descriptions but {len(prompts)} prompts")

        d = self.description_tokenizer(descs, padding=True, return_tensors="np")
        p = self.prompt_tokenizer(prompts, padding=True, return_tensors="np")
        dl, pl = _bucket(d.input_ids.shape[1]), _bucket(p.input_ids.shape[1])
        desc_pad = ((0, 0), (0, dl - d.input_ids.shape[1]))
        prompt_pad = ((0, 0), (pl - p.input_ids.shape[1], 0))  # prompts pad LEFT

        max_len = self.gen.max_length
        if max_seconds is not None:
            max_len = int(max_seconds * self.cfg.frame_rate) + self.cfg.decoder.num_codebooks
        out = generate(
            self.model, dataclasses.replace(self.gen, max_length=max_len),
            input_ids=np.pad(d.input_ids, desc_pad),
            attention_mask=np.pad(d.attention_mask, desc_pad),
            prompt_input_ids=np.pad(p.input_ids, prompt_pad),
            prompt_attention_mask=np.pad(p.attention_mask, prompt_pad),
            generator=torch.Generator(device=self.device).manual_seed(seed),
            device=self.device,
        )
        audio = out.audio
        if self.pcm16:
            audio = (audio.float().clamp(-1.0, 1.0) * 32767.0).to(torch.int16)
        audio = audio.cpu().numpy()
        lengths = out.audio_lengths.cpu().numpy()
        return self.cfg.sampling_rate, [audio[i, : lengths[i]] for i in range(audio.shape[0])]
