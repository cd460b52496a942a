"""Meta EnCodec: encode (waveform -> codes) and decode (codes -> waveform).

Port of ``parler_tts_tpu/models/encodec.py``, the second codec family beside
the DAC (``models/dac.py``), with the same interface:

* SEANet encoder: EnCodec convolutions (extra right padding so that output
  frames are whole; causal, all padding on the left, or asymmetric; reflect
  padding with torch's escape for short inputs), ELU resnet blocks, strided
  downsampling over ``reversed(upsampling_ratios)``, a 2-layer LSTM with one
  residual around the stack, and a final conv to the latent;
* a plain Euclidean residual vector quantizer in the full latent space (no
  projections), distances and residuals in fp32; the codebook count follows
  the target bandwidth unless it is pinned;
* SEANet decoder: the mirror, transposed convolutions trimmed after their
  optional norm (causal: ``ceil(pad_total * trim_right_ratio)`` on the
  right);
* the 48 kHz variant's ``time_group_norm`` (``GroupNorm(1, C)`` in fp32),
  per-frame loudness scales, and chunked encode with a linear-fade
  overlap-add decode.

Activations are NCW inside; the public functions take the JAX layouts,
waveforms (B, T) mono or (B, T, channels) and codes (B, K, frames).  The
convolutions are ``nn.Conv1d`` / ``nn.ConvTranspose1d`` and the LSTM is
``nn.LSTM``; in the JAX package these are XLA ops (``conv_general_dilated``,
a ``lax.scan`` with the input projection hoisted out), not Pallas kernels.
Encode and decode turn cuDNN's TF32 off around the conv stacks, which also
covers a cuDNN LSTM: an fp32 codec is fp32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from parler_tts_tpu_torch.core.config import EncodecConfig
from parler_tts_tpu_torch.ops.conv import fp32_convolutions


def pad1d(x: torch.Tensor, left: int, right: int, mode: str) -> torch.Tensor:
    """Pad (B, C, T) along time.  Reflect mode takes torch's escape for
    short inputs: when T <= max(pad), zero-pad the right first so that the
    reflection is defined, then drop that tail."""
    if left == 0 and right == 0:
        return x
    if mode != "reflect":
        return F.pad(x, (left, right))
    t = x.shape[-1]
    extra = max(left, right) - t + 1 if t <= max(left, right) else 0
    if extra:
        x = F.pad(x, (0, extra))
    y = F.pad(x, (left, right), mode="reflect")
    return y[..., : y.shape[-1] - extra] if extra else y


class TimeGroupNorm(nn.Module):
    """``GroupNorm(1, C)``: each sample normalized jointly over (C, T) in
    fp32, eps 1e-5, then a per-channel affine."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), 1, self.scale.float(), self.bias.float(), 1e-5).to(x.dtype)


class EncodecConv1d(nn.Conv1d):
    """EnCodec's Conv1d (HF ``EncodecConv1d``): padding computed from the
    input so that the output frames are whole, then the conv, then the
    optional time group norm."""

    def __init__(self, cfg: EncodecConfig, c_in: int, c_out: int, width: int, *, stride: int = 1,
                 dilation: int = 1):
        super().__init__(c_in, c_out, width, stride=stride, dilation=dilation)
        self.causal, self.pad_mode = cfg.use_causal_conv, cfg.pad_mode
        self.norm = TimeGroupNorm(c_out) if cfg.norm_type == "time_group_norm" else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stride, eff_k = self.stride[0], (self.kernel_size[0] - 1) * self.dilation[0] + 1
        pad_total = eff_k - stride
        t = x.shape[-1]
        n_frames = math.ceil((t - eff_k + pad_total) / stride + 1) - 1
        extra = n_frames * stride + eff_k - pad_total - t
        if self.causal:
            left, right = pad_total, extra
        else:
            right_half = pad_total // 2
            left, right = pad_total - right_half, right_half + extra
        y = super().forward(pad1d(x, left, right, self.pad_mode))
        return y if self.norm is None else self.norm(y)


class EncodecConvTranspose1d(nn.ConvTranspose1d):
    """EnCodec's ConvTranspose1d: the full transposed conv, the optional norm,
    then a fixed trim of ``width - stride`` samples (causal: ``ceil(pad_total
    * trim_right_ratio)`` of them on the right)."""

    def __init__(self, cfg: EncodecConfig, c_in: int, c_out: int, width: int, *, stride: int):
        super().__init__(c_in, c_out, width, stride=stride)
        self.causal, self.trim_right_ratio = cfg.use_causal_conv, cfg.trim_right_ratio
        self.norm = TimeGroupNorm(c_out) if cfg.norm_type == "time_group_norm" else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad_total = self.kernel_size[0] - self.stride[0]
        y = super().forward(x)
        if self.norm is not None:
            y = self.norm(y)
        right = math.ceil(pad_total * self.trim_right_ratio) if self.causal else pad_total // 2
        return y[..., pad_total - right : y.shape[-1] - right]


class EncodecLSTM(nn.LSTM):
    """``nn.LSTM(dim, dim, layers)`` over (B, C, T) with one residual around
    the whole stack (HF ``EncodecLSTM``); torch's gate order i, f, g, o."""

    def __init__(self, dim: int, layers: int):
        super().__init__(dim, dim, layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, _ = super().forward(x.permute(2, 0, 1))
        return y.permute(1, 2, 0) + x


class ResnetBlock(nn.Module):
    """ELU -> dilated conv (dim -> dim / compress) -> ELU -> 1x1 conv (-> dim),
    added to a 1x1 conv shortcut or to the input."""

    def __init__(self, cfg: EncodecConfig, dim: int, dilation: int):
        super().__init__()
        hidden = dim // cfg.compress
        self.conv1 = EncodecConv1d(cfg, dim, hidden, cfg.residual_kernel_size, dilation=dilation)
        self.conv2 = EncodecConv1d(cfg, hidden, dim, 1)
        self.shortcut = EncodecConv1d(cfg, dim, dim, 1) if cfg.use_conv_shortcut else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(F.elu(self.conv1(F.elu(x))))
        return (x if self.shortcut is None else self.shortcut(x)) + y


def _res_stack(cfg: EncodecConfig, dim: int) -> nn.ModuleList:
    return nn.ModuleList(ResnetBlock(cfg, dim, cfg.dilation_growth_rate**j) for j in range(cfg.num_residual_layers))


class EncoderBlock(nn.Module):
    def __init__(self, cfg: EncodecConfig, dim: int, ratio: int):
        super().__init__()
        self.res = _res_stack(cfg, dim)
        self.conv_down = EncodecConv1d(cfg, dim, 2 * dim, 2 * ratio, stride=ratio)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.res:
            x = block(x)
        return self.conv_down(F.elu(x))


class DecoderBlock(nn.Module):
    def __init__(self, cfg: EncodecConfig, dim: int, ratio: int):
        super().__init__()
        self.conv_up = EncodecConvTranspose1d(cfg, dim, dim // 2, 2 * ratio, stride=ratio)
        self.res = _res_stack(cfg, dim // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_up(F.elu(x))
        for block in self.res:
            x = block(x)
        return x


class SEANetEncoder(nn.Module):
    """(B, channels, T) waveform -> (B, hidden_size, T / hop) latents."""

    def __init__(self, cfg: EncodecConfig):
        super().__init__()
        dim = cfg.num_filters
        self.conv_in = EncodecConv1d(cfg, cfg.audio_channels, dim, cfg.kernel_size)
        blocks = []
        for ratio in reversed(cfg.upsampling_ratios):
            blocks.append(EncoderBlock(cfg, dim, ratio))
            dim *= 2
        self.blocks = nn.ModuleList(blocks)
        self.lstm = EncodecLSTM(dim, cfg.num_lstm_layers)
        self.conv_out = EncodecConv1d(cfg, dim, cfg.hidden_size, cfg.last_kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.blocks:
            x = block(x)
        return self.conv_out(F.elu(self.lstm(x)))


class SEANetDecoder(nn.Module):
    """(B, hidden_size, T) latents -> (B, channels, T * hop) fp32 waveform."""

    def __init__(self, cfg: EncodecConfig):
        super().__init__()
        dim = 2 ** len(cfg.upsampling_ratios) * cfg.num_filters
        self.conv_in = EncodecConv1d(cfg, cfg.hidden_size, dim, cfg.kernel_size)
        self.lstm = EncodecLSTM(dim, cfg.num_lstm_layers)
        blocks = []
        for ratio in cfg.upsampling_ratios:
            blocks.append(DecoderBlock(cfg, dim, ratio))
            dim //= 2
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = EncodecConv1d(cfg, dim, cfg.audio_channels, cfg.last_kernel_size)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.lstm(self.conv_in(z))
        for block in self.blocks:
            x = block(x)
        return self.conv_out(F.elu(x)).float()


class EuclideanRVQ(nn.Module):
    """Residual vector quantization over ``num_quantizers`` unprojected
    codebooks (N, D), nearest code by Euclidean distance, in fp32."""

    def __init__(self, cfg: EncodecConfig):
        super().__init__()
        self.codebooks = nn.Parameter(torch.empty(cfg.num_quantizers, cfg.codebook_size, cfg.codebook_dim))

    def _walk(self, z: torch.Tensor, n: int, forced: torch.Tensor | None):
        """The residual walk over the first ``n`` codebooks: yields each
        codebook's scores (B, T, N), ``2 r.e - |r|^2 - |e|^2`` (the negated
        squared distance), and the code taken, its argmax or ``forced``'s."""
        residual = z.float()
        for k in range(n):
            cb = self.codebooks[k].float()
            scores = (2.0 * torch.einsum("btd,nd->btn", residual, cb) - residual.square().sum(-1, keepdim=True)
                      - cb.square().sum(-1))
            idx = scores.argmax(dim=-1) if forced is None else forced[:, k].long()
            yield scores, idx
            residual = residual - cb[idx]

    @torch.no_grad()
    def encode(self, z: torch.Tensor, n_quantizers: int) -> torch.Tensor:
        """(B, T, D) latents -> (B, n_quantizers, T) int32 codes."""
        return torch.stack([idx for _, idx in self._walk(z, n_quantizers, None)], dim=1).to(torch.int32)

    @torch.no_grad()
    def code_gaps(self, z: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
        """For codes computed elsewhere: walk ``z`` taking those codes and
        return, per (B, K, T), how far each code's score falls below the best
        score there (0 where it is the argmax).  Codes that differ at a
        near-tie have a gap at the level of the latents' rounding."""
        gaps = [scores.amax(-1) - scores.gather(-1, idx[..., None])[..., 0]
                for scores, idx in self._walk(z, codes.shape[1], codes)]
        return torch.stack(gaps, dim=1)

    def from_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """(B, K, T) codes, any K up to ``num_quantizers`` -> (B, T, D) fp32
        sum of the codebooks' vectors."""
        k = codes.shape[1]
        picked = self.codebooks.float()[torch.arange(k, device=codes.device)[None, :, None], codes.long()]
        return picked.sum(dim=1)


def _channels_first(audio: torch.Tensor) -> torch.Tensor:
    """(B, T) or (B, T, channels) -> (B, channels, T)."""
    return audio[:, None] if audio.ndim == 2 else audio.transpose(1, 2)


def overlap_add(frames: list[torch.Tensor], stride: int) -> torch.Tensor:
    """Linear-fade overlap-add of (B, T[, ch]) pieces ``stride`` apart (HF
    ``_linear_overlap_add``): triangular weights peaking mid-piece,
    normalized by their sum at each sample."""
    first = frames[0]
    total = stride * (len(frames) - 1) + frames[-1].shape[1]
    t = torch.linspace(0.0, 1.0, first.shape[1] + 2, dtype=torch.float32, device=first.device)[1:-1]
    weight = 0.5 - (t - 0.5).abs()
    out = torch.zeros((first.shape[0], total, *first.shape[2:]), dtype=torch.float32, device=first.device)
    sum_w = torch.zeros(total, dtype=torch.float32, device=first.device)
    for i, f in enumerate(frames):
        n, off = f.shape[1], i * stride
        w = weight[:n]
        out[:, off : off + n] += (w[:, None] if f.ndim == 3 else w) * f
        sum_w[off : off + n] += w
    return out / (sum_w[:, None] if out.ndim == 3 else sum_w)


class Encodec(nn.Module):
    """Waveform <-> codes.  Parameter names follow the JAX tree
    (``quantizer.*``, ``decoder.*``, ``encoder.*``)."""

    def __init__(self, cfg: EncodecConfig):
        super().__init__()
        self.cfg = cfg
        self.quantizer = EuclideanRVQ(cfg)
        self.decoder = SEANetDecoder(cfg)
        self.encoder = SEANetEncoder(cfg)

    def num_quantizers_for_bandwidth(self, bandwidth: float | None) -> int:
        """HF ``get_num_quantizers_for_bandwidth``: every codebook for None
        or a bandwidth <= 0."""
        if bandwidth is None or bandwidth <= 0.0:
            return self.cfg.num_quantizers
        return int(max(1, math.floor(bandwidth * 1000 / (self.cfg.codebook_nbits * self.cfg.frame_rate))))

    @torch.no_grad()
    def latents(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, T[, ch]) waveform -> (B, frames, hidden_size) latents; the conv
        stack in the module's dtype with cuDNN's TF32 off."""
        x = _channels_first(audio).to(self.encoder.conv_in.weight.dtype)
        with fp32_convolutions():
            return self.encoder(x).transpose(1, 2)

    def _encode_frame(self, frame: torch.Tensor, n_q: int):
        scale = None
        if self.cfg.normalize:
            x = frame.float() if frame.ndim == 3 else frame.float()[..., None]
            scale = x.mean(dim=-1).square().mean(dim=-1, keepdim=True).sqrt() + 1e-8  # (B, 1)
            frame = frame / (scale[..., None] if frame.ndim == 3 else scale)
        return self.quantizer.encode(self.latents(frame), n_q), scale

    @torch.no_grad()
    def encode(self, audio: torch.Tensor, *, bandwidth: float | None = None, n_quantizers: int | None = None):
        """(B, T[, ch]) waveform -> (B, K, frames) int32 codes, or ``(codes,
        scales (B, 1))`` when the config normalizes.  K follows ``bandwidth``
        (default: the config's first) unless ``n_quantizers`` pins it.  For an
        unchunked config only."""
        if self.cfg.chunk_length is not None:
            raise ValueError("chunked EnCodec config: use encode_chunked / decode_chunked")
        n_q = n_quantizers or self.num_quantizers_for_bandwidth(
            bandwidth if bandwidth is not None else self.cfg.target_bandwidths[0])
        codes, scale = self._encode_frame(audio, n_q)
        return (codes, scale) if self.cfg.normalize else codes

    def decode(self, codes: torch.Tensor, scales: torch.Tensor | None = None) -> torch.Tensor:
        """(B, K, frames) codes -> (B, frames * hop[, ch]) fp32 waveform, the
        convs and LSTM in the module's dtype; ``scales`` (B, 1) multiply it."""
        z = self.quantizer.from_codes(codes).to(self.decoder.conv_in.weight.dtype)
        with fp32_convolutions():
            audio = self.decoder(z.transpose(1, 2))
        audio = audio[:, 0] if self.cfg.audio_channels == 1 else audio.transpose(1, 2)
        if scales is not None:
            s = scales.float()
            audio = audio * (s[..., None] if audio.ndim == 3 else s)
        return audio

    @torch.no_grad()
    def encode_chunked(self, audio: torch.Tensor, *, bandwidth: float | None = None,
                       padding_mask: torch.Tensor | None = None):
        """Overlapping chunks of ``chunk_length`` every ``chunk_stride``
        samples, each encoded (HF ``EncodecModel.encode`` with
        ``chunk_length_s``).  Returns ``(codes (F, B, K, Tf), scales (F, B,
        1) or None, last_frame_pad_length)``, the last chunk's codes
        zero-padded to stack."""
        x = audio if audio.ndim == 3 else audio[..., None]
        t = x.shape[1]
        chunk, stride = self.cfg.chunk_length, self.cfg.chunk_stride
        if chunk is None:
            chunk = stride = t
        n_q = self.num_quantizers_for_bandwidth(bandwidth if bandwidth is not None else self.cfg.target_bandwidths[0])
        if padding_mask is None:
            padding_mask = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
        frames, scales = [], []
        for off in range(0, t, stride):
            piece = x[:, off : off + chunk] * padding_mask[:, off : off + chunk, None].to(x.dtype)
            codes, scale = self._encode_frame(piece, n_q)
            frames.append(codes)
            scales.append(scale)
        last_pad = frames[0].shape[-1] - frames[-1].shape[-1]
        if last_pad > 0:
            frames[-1] = F.pad(frames[-1], (0, last_pad))
        return torch.stack(frames), (torch.stack(scales) if self.cfg.normalize else None), last_pad

    def decode_chunked(self, codes: torch.Tensor, *, scales: torch.Tensor | None = None,
                       last_frame_pad_length: int = 0) -> torch.Tensor:
        """(F, B, K, Tf) chunked codes -> the overlap-added waveform."""
        n = codes.shape[0]
        pieces = []
        for i in range(n):
            frame = codes[i]
            if i == n - 1 and last_frame_pad_length > 0:
                frame = frame[..., :-last_frame_pad_length]
            pieces.append(self.decode(frame, None if scales is None else scales[i]))
        return pieces[0] if n == 1 else overlap_add(pieces, self.cfg.chunk_stride or 1)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX ``init``'s distributions: conv kernels 0.02 *
        truncnormal(-2, 2), LSTM matrices normal(0, 0.02), zero biases (both
        LSTM biases), unit norm scales, codebooks normal(0, 1) (HF's are
        zeros until trained).  The encode side draws last, so the decode
        side's weights are those of a codec without it."""
        for name, p in sorted(self.named_parameters(), key=lambda item: item[0].startswith("encoder.")):
            leaf = name.rsplit(".", 1)[-1]
            if name == "quantizer.codebooks":
                p.normal_(0.0, 1.0, generator=generator)
            elif leaf == "scale":
                p.fill_(1.0)
            elif leaf.startswith("bias"):
                p.zero_()
            elif leaf.startswith("weight_"):
                p.normal_(0.0, 0.02, generator=generator)
            else:
                nn.init.trunc_normal_(p, 0.0, 1.0, -2.0, 2.0, generator=generator).mul_(0.02)
