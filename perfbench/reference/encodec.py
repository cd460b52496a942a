"""The EnCodec decoder (``facebook/encodec_24khz`` as in HF
``EncodecModel.decode``): the sum of the codebooks' vectors, then the SEANet
decoder: conv7, a residual LSTM stack, per ratio an ELU, a transposed conv
of width 2 * ratio trimmed on the right (causal) and resnet blocks
(ELU, conv3 to dim / compress, ELU, conv1 back, plus a 1x1 shortcut), then
ELU and conv7.  Causal convolutions pad on the left, reflecting, with the
extra right padding that keeps output frames whole."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference import Weights


def pad_reflect(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    t = x.shape[-1]
    extra = max(left, right) - t + 1 if t <= max(left, right) else 0
    if extra:
        x = F.pad(x, (0, extra))
    y = F.pad(x, (left, right), mode="reflect")
    return y[..., : y.shape[-1] - extra] if extra else y


def conv(w: Weights, name: str, x: torch.Tensor, cfg: dict, *, stride: int = 1, dilation: int = 1) -> torch.Tensor:
    weight = w(name + ".weight")
    eff = (weight.shape[-1] - 1) * dilation + 1
    pad_total = eff - stride
    t = x.shape[-1]
    frames = (t - eff + pad_total) / stride + 1
    extra = (math.ceil(frames) - 1) * stride + (eff - pad_total) - t
    if cfg["use_causal_conv"]:
        left, right = pad_total, extra
    else:
        left, right = pad_total - pad_total // 2, pad_total // 2 + extra
    x = pad_reflect(x, left, right) if cfg["pad_mode"] == "reflect" else F.pad(x, (left, right))
    return F.conv1d(x, weight, w(name + ".bias"), stride=stride, dilation=dilation)


def conv_up(w: Weights, name: str, x: torch.Tensor, cfg: dict, stride: int) -> torch.Tensor:
    weight = w(name + ".weight")
    pad_total = weight.shape[-1] - stride
    y = F.conv_transpose1d(x, weight, w(name + ".bias"), stride=stride)
    right = math.ceil(pad_total * cfg["trim_right_ratio"]) if cfg["use_causal_conv"] else pad_total // 2
    return y[..., pad_total - right: y.shape[-1] - right]


def lstm(w: Weights, name: str, x: torch.Tensor, layers: int) -> torch.Tensor:
    """(B, C, T) through ``layers`` LSTM layers (gates i, f, g, o), plus the
    input."""
    h_seq = x.permute(2, 0, 1)  # (T, B, C)
    for layer in range(layers):
        w_ih, w_hh = w(f"{name}.weight_ih_l{layer}"), w(f"{name}.weight_hh_l{layer}")
        bias = w(f"{name}.bias_ih_l{layer}") + w(f"{name}.bias_hh_l{layer}")
        pre = h_seq @ w_ih.T + bias
        h = torch.zeros_like(h_seq[0])
        c = torch.zeros_like(h)
        out = []
        for t in range(pre.shape[0]):
            i, f, g, o = (pre[t] + h @ w_hh.T).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            out.append(h)
        h_seq = torch.stack(out)
    return h_seq.permute(1, 2, 0) + x


def decode(w: Weights, cfg: dict, codes: torch.Tensor) -> torch.Tensor:
    """(B, K, T) codes -> (B, T * hop) mono waveform."""
    if cfg.get("norm_type", "weight_norm") != "weight_norm" or cfg.get("audio_channels", 1) != 1:
        raise NotImplementedError("the reference decodes the mono, weight-normed (folded) EnCodec")
    k = codes.shape[1]
    cb = w("quantizer.codebooks")
    x = cb[torch.arange(k, device=codes.device)[None, :, None], codes.long()].sum(1).transpose(1, 2)
    dw = w.sub("decoder.")
    x = lstm(dw, "lstm", conv(dw, "conv_in", x, cfg), cfg["num_lstm_layers"])
    for i, ratio in enumerate(cfg["upsampling_ratios"]):
        x = conv_up(dw, f"blocks.{i}.conv_up", F.elu(x), cfg, ratio)
        for j in range(cfg["num_residual_layers"]):
            r = f"blocks.{i}.res.{j}."
            y = conv(dw, r + "conv1", F.elu(x), cfg, dilation=cfg["dilation_growth_rate"] ** j)
            y = conv(dw, r + "conv2", F.elu(y), cfg)
            x = (conv(dw, r + "shortcut", x, cfg) if cfg["use_conv_shortcut"] else x) + y
    return conv(dw, "conv_out", F.elu(x), cfg)[:, 0]
