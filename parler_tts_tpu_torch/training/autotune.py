"""The training step's memory plan on the H100: per-layer recompute or not.

Port of ``parler_tts_tpu/training/autotune.py``.  The plan is only
``remat`` in {False, True}: the port's layers are a Python loop, so there is
no scan to unroll, and the JAX ``"dots"`` policy becomes the port's one
recompute mode.  The step runs without recompute when the estimated peak
fits the card, else with it; explicit arguments always win.

The estimate is ``peak = F + a * batch * fused_len`` for each mode, fitted
by ``tools/train_memory_fit.py`` (least squares) to
``torch.cuda.max_memory_allocated`` over train steps of Mini (fp32
parameters, bf16 compute, AdamW, dropout 0.1) at batch x seconds of 3 x 10,
1 x 30, 8 x 10, 4 x 30, 16 x 10 and 8 x 30 (2,623 to 20,984 tokens) on an
NVIDIA H100 80GB HBM3 at a 700 W power limit:

* without recompute: F = 7.651 GB, a = 1.533 MB per token (peaks 11.86 to
  39.95 GB, every point within 0.21 GB of the line);
* with recompute: F = 11.801 GB, a = 0.019 MB per token (11.85 to 12.20 GB,
  within 0.007 GB): the peak is the optimizer's (fp32 masters, grads, two
  AdamW moments and their temporaries), not the activations'.

The fit holds for Mini's shapes only (its decoder, prompt embedding,
projection and text encoder); no other config has been measured, so any
other config runs without recompute unless the arguments ask for it.  The
limit is the card's ``torch.cuda.get_device_properties(dev).total_memory``
less a 2 GB margin; off the card it is the H100's, so that a plan made on
the CPU is the card's.  At Mini without recompute the line reaches that
limit at about 49,000 tokens (batch 18 x 30 s).
"""

from __future__ import annotations

import dataclasses

import torch

from parler_tts_tpu_torch.core.config import ParlerTTSConfig, mini_600m_config

H100_MEMORY_BYTES = 85_017_493_504  # total_memory of the H100 80GB HBM3
# the fits of the module docstring, at Mini: (F bytes, a bytes per token)
_FIT = {False: (7.651217e9, 1.533115e6), True: (11.800775e9, 1.9010e4)}
_MARGIN_BYTES = 2e9


def trainable_decoder_params(cfg: ParlerTTSConfig) -> int:
    """Trainable parameter count: decoder, prompt embedding and projection
    (the text encoder and the codec are frozen)."""
    d = cfg.decoder
    h, L, ffn, K, V = d.hidden_size, d.num_hidden_layers, d.ffn_dim, d.num_codebooks, d.vocab_size
    embeds = K * (V + 1) * h
    layer = 8 * h * h + 2 * h * ffn + 6 * h  # self qkvo + cross qkvo + fc1/fc2 + 3 LNs
    heads = K * V * h
    prompt_embed = cfg.vocab_size * h
    proj = (cfg.text_encoder.d_model * h + h) if cfg.text_encoder.d_model != h else 0
    return embeds + L * layer + heads + prompt_embed + proj


@dataclasses.dataclass
class TrainPlan:
    remat: bool
    est_peak_bytes: float | None  # None: no fit for this config
    memory_limit_bytes: float


def _fitted(cfg: ParlerTTSConfig) -> bool:
    """Whether ``cfg`` has Mini's trainable shapes and text encoder, the
    only config the fit was measured on."""
    mini = mini_600m_config()
    return (cfg.text_encoder == mini.text_encoder and trainable_decoder_params(cfg) == trainable_decoder_params(mini)
            and (cfg.decoder.num_hidden_layers, cfg.decoder.hidden_size)
            == (mini.decoder.num_hidden_layers, mini.decoder.hidden_size))


def estimate_peak_bytes(cfg: ParlerTTSConfig, *, per_device_batch: int, fused_len: int,
                        remat: bool) -> float | None:
    """The fitted peak for this shape at Mini (see the module docstring);
    None for another config."""
    if not _fitted(cfg):
        return None
    fixed, per_token = _FIT[remat]
    return fixed + per_token * per_device_batch * fused_len


def memory_limit(device: str | torch.device | None = None) -> float:
    """The card's memory in bytes; the H100's off the card."""
    device = torch.device(device) if device is not None else None
    if device is not None and device.type == "cuda":
        return float(torch.cuda.get_device_properties(device).total_memory)
    return float(H100_MEMORY_BYTES)


def plan_train_memory(cfg: ParlerTTSConfig, *, per_device_batch: int, fused_len: int,
                      memory_limit_bytes: float | None = None,
                      device: str | torch.device | None = None) -> TrainPlan:
    """No recompute when its estimated peak fits the limit less a margin, or
    when the config has no fit; else recompute.  ``fused_len`` = prompt_len
    + label_len."""
    limit = memory_limit_bytes or memory_limit(device)
    est = estimate_peak_bytes(cfg, per_device_batch=per_device_batch, fused_len=fused_len, remat=False)
    if est is None or est <= limit - _MARGIN_BYTES:
        return TrainPlan(False, est, limit)
    return TrainPlan(True, estimate_peak_bytes(cfg, per_device_batch=per_device_batch, fused_len=fused_len,
                                               remat=True), limit)


def resolve_train_plan(cfg: ParlerTTSConfig, *, per_device_batch: int, fused_len: int,
                       gradient_checkpointing: bool | None, gradient_checkpointing_policy: str,
                       memory_limit_bytes: float | None = None,
                       device: str | torch.device | None = None) -> bool:
    """Merge the arguments with the plan -> remat.  ``gradient_checkpointing``
    True or False wins; left None, a policy other than ``"auto"`` ("full",
    "dots") asks for recompute, and ``"auto"`` takes the plan's choice."""
    if gradient_checkpointing is not None:
        return bool(gradient_checkpointing)
    if gradient_checkpointing_policy != "auto":
        return True
    return plan_train_memory(cfg, per_device_batch=per_device_batch, fused_len=fused_len,
                             memory_limit_bytes=memory_limit_bytes, device=device).remat
