"""Text in, waveform out (port of ``parler_tts_tpu/pipeline.py``).

``ParlerTTSPipeline.tts(descriptions, prompts)`` tokenizes, pads to length
buckets (descriptions on the right, prompts on the LEFT), generates and
trims each waveform to its valid length.  Any tokenizer with the HF call
shape works: ``tok(list_of_str, padding=True, return_tensors="np")`` giving
``.input_ids`` and ``.attention_mask``; ``from_pretrained`` reads the
artifact's own with ``utils/tokenizer.Tokenizer``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch

from parler_tts_tpu_torch.core import checkpoint as ck
from parler_tts_tpu_torch.core.config import GenerationConfig, ParlerTTSConfig
from parler_tts_tpu_torch.core.device import resolve_device
from parler_tts_tpu_torch.generation.generate import generate
from parler_tts_tpu_torch.models.parler import ParlerTTSModel
from parler_tts_tpu_torch.utils import profiling
from parler_tts_tpu_torch.utils.tokenizer import Tokenizer


def _bucket(n: int, sizes=(16, 32, 64, 128, 256)) -> int:
    for s in sizes:
        if n <= s:
            return s
    return ((n + 63) // 64) * 64


@dataclasses.dataclass
class ParlerTTSPipeline:
    """``model`` is moved to ``device`` and cast to ``dtype`` in place.
    ``pcm16=True`` returns int16 waveforms, the truncating cast a WAV body
    holds, instead of float32 in [-1, 1].  ``from_pretrained`` builds one from
    a model artifact directory."""

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

    @classmethod
    def from_pretrained(cls, model_dir: str, *, tokenizer: Any = None, tokenizer_name: str | None = None,
                        dtype: torch.dtype = torch.bfloat16, pcm16: bool = False,
                        device: str | torch.device = "cuda") -> "ParlerTTSPipeline":
        """Load a model artifact that ``core/checkpoint.save_model`` wrote
        (the training CLI's ``final/``), cast to ``dtype`` on ``device``.
        The tokenizer serving descriptions and prompts is ``tokenizer`` (an
        object with the HF call shape), else the one read from the directory
        ``tokenizer_name``, else the artifact's own, read from its
        ``tokenizer.json`` (``utils/tokenizer.Tokenizer``).  An artifact that
        holds tokenizer files but no ``tokenizer.json`` raises; one with
        none gives a pipeline whose ``tts`` raises."""
        if tokenizer is None:
            if tokenizer_name is None and any(os.path.exists(os.path.join(model_dir, f))
                                              for f in ("tokenizer.json", "tokenizer_config.json", "spiece.model")):
                tokenizer_name = model_dir
            if tokenizer_name is not None:
                tokenizer = Tokenizer.from_pretrained(tokenizer_name)
        model, cfg, gen = ck.load_model(model_dir, device=device, dtype=dtype)
        return cls(model, cfg, gen, tokenizer, tokenizer, dtype=dtype, pcm16=pcm16, device=device)

    def tokenize(self, descriptions: list[str], prompts: list[str]) -> dict[str, np.ndarray]:
        """``generate``'s ids and masks: descriptions padded on the right and
        prompts on the LEFT, each to a length bucket."""
        d = self.description_tokenizer(descriptions, padding=True, return_tensors="np")
        p = self.prompt_tokenizer(prompts, padding=True, return_tensors="np")
        dl, pl = _bucket(d.input_ids.shape[1]), _bucket(p.input_ids.shape[1])
        desc_pad = ((0, 0), (0, dl - d.input_ids.shape[1]))
        prompt_pad = ((0, 0), (pl - p.input_ids.shape[1], 0))
        return dict(input_ids=np.pad(d.input_ids, desc_pad), attention_mask=np.pad(d.attention_mask, desc_pad),
                    prompt_input_ids=np.pad(p.input_ids, prompt_pad),
                    prompt_attention_mask=np.pad(p.attention_mask, prompt_pad))

    def max_length(self, max_seconds: float | None) -> int:
        """Token positions for ``max_seconds`` of audio, the delay pattern's
        tail included; the generation config's with None."""
        if max_seconds is None:
            return self.gen.max_length
        return int(max_seconds * self.cfg.frame_rate) + self.cfg.decoder.num_codebooks

    def tts(self, description: str | list[str], prompt: str | list[str], *, seed: int = 0,
            max_seconds: float | None = None) -> tuple[int, list[np.ndarray]]:
        """-> (sampling_rate, [waveform per sample]).  ``seed`` seeds the
        sampler's ``torch.Generator``.  Traced as the span ``tts`` (the root
        of a call) over ``tts.tokenize``, ``generate``'s spans, the codec's
        and ``tts.to_host`` (``utils/profiling.py``)."""
        if self.description_tokenizer is None or self.prompt_tokenizer is None:
            raise RuntimeError("the pipeline needs a description and a prompt tokenizer")
        descs = [description] if isinstance(description, str) else list(description)
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        if len(descs) != len(prompts):
            raise ValueError(f"{len(descs)} descriptions but {len(prompts)} prompts")

        with profiling.span("tts", self.device, rows=len(descs), max_seconds=max_seconds):
            with profiling.span("tts.tokenize"):
                inputs = self.tokenize(descs, prompts)
            out = generate(
                self.model, dataclasses.replace(self.gen, max_length=self.max_length(max_seconds)), **inputs,
                generator=torch.Generator(device=self.device).manual_seed(seed),
                device=self.device,
            )
            with profiling.span("tts.to_host", self.device):
                audio = out.audio
                if self.pcm16:
                    audio = (audio.float().clamp(-1.0, 1.0) * 32767.0).to(torch.int16)
                audio = audio.cpu().numpy()
                lengths = out.audio_lengths.cpu().numpy()
                waves = [audio[i, : lengths[i]] for i in range(audio.shape[0])]
        return self.cfg.sampling_rate, waves
