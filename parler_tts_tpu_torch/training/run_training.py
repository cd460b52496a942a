"""Training data preparation.  Of ``parler_tts_tpu/training/run_training.py``
only the synthetic dataset is ported; the CLI, dataset loading, checkpoints
and evaluation come later."""

from __future__ import annotations

import numpy as np

from parler_tts_tpu_torch.training.data import build_labels


def prepare_synthetic(n: int, cfg, *, seed: int = 0, desc_len: int = 24, prompt_len: int = 16,
                      codes_len: int = 64) -> list[dict]:
    """``n`` random samples (description ids, prompt ids, delay-pattern
    labels of ``codes_len // 2`` to ``codes_len`` frames, padded to
    ``codes_len + K + 2``), drawn from ``seed`` in the JAX function's order,
    so both give the same samples."""
    rng = np.random.default_rng(seed)
    dcfg = cfg.decoder
    samples = []
    for i in range(n):
        t = int(rng.integers(codes_len // 2, codes_len + 1))
        codes = rng.integers(0, cfg.audio_encoder.codebook_size, (dcfg.num_codebooks, t)).astype(np.int16)
        labels, _ = build_labels([codes], bos_token_id=dcfg.bos_token_id, eos_token_id=dcfg.eos_token_id,
                                 max_length=codes_len + dcfg.num_codebooks + 2)
        samples.append({
            "input_ids": rng.integers(0, cfg.text_encoder.vocab_size, (int(rng.integers(8, desc_len + 1)),)),
            "prompt_input_ids": rng.integers(0, cfg.vocab_size, (int(rng.integers(6, prompt_len + 1)),)),
            "labels": labels[0],
            "prompt_text": f"synthetic prompt {i}",
            "description_text": f"synthetic description {i}",
        })
    return samples
