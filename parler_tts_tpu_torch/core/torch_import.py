"""HF / reference state_dicts -> the port's state_dict names.

Port of ``parler_tts_tpu/core/torch_import.py``.  Each importer takes a
``{name: tensor or ndarray}`` mapping under the reference's names and returns
the state_dict of one port module (T5 encoder, decoder, DAC, EnCodec), for
``load_state_dict(strict=True)``: a name the port lacks or a parameter the
checkpoint lacks raises there.  The layouts differ from the JAX importer's:

* an HF ``Linear`` weight ``(out, in)`` becomes the port's ``(in, out)``
  ``Dense`` kernel: transposed, as JAX's;
* codec convolutions are torch ``Conv1d`` / ``ConvTranspose1d`` in both, so
  their weights are copied as they are (no WIO transpose, no time flip);
  weight norm (``weight_g`` / ``weight_v`` or
  ``parametrizations.weight.original0/1``) is folded in float64 with the
  norm over every dimension but 0, then cast to fp32, as JAX's;
* decoder layers stay separate ``layers.{i}`` entries (JAX stacks them on a
  leading axis), and the EnCodec LSTM keeps torch's four tensors per layer
  (JAX folds ``bias_ih + bias_hh``).

Transposes are views of the source tensors, so importing keeps no second
copy of the weights; ``load_state_dict`` copies each into its parameter.
"""

from __future__ import annotations

from typing import Mapping

import torch

from parler_tts_tpu_torch.core.config import EncodecConfig

StateDict = dict[str, torch.Tensor]


def as_tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(x)


def _lin(sd: Mapping, name: str) -> torch.Tensor:
    """An HF Linear weight as an ``(in, out)`` kernel (a view)."""
    return as_tensor(sd[f"{name}.weight"]).T


def import_t5_encoder(sd: Mapping, num_layers: int, prefix: str = "encoder") -> StateDict:
    """HF ``T5EncoderModel`` (or the encoder of a ``T5Model``) -> the port's
    ``T5Encoder``.  ``shared.weight`` falls back to
    ``{prefix}.embed_tokens.weight`` (safetensors drop the tied alias); a
    non-gated T5 v1.0 FFN has ``wi`` in place of ``wi_0`` / ``wi_1``."""
    shared = "shared.weight" if "shared.weight" in sd else f"{prefix}.embed_tokens.weight"
    out = {
        "token_embed.embedding": as_tensor(sd[shared]),
        "rel_attn_bias.embedding": as_tensor(
            sd[f"{prefix}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"]),
        "final_ln.scale": as_tensor(sd[f"{prefix}.final_layer_norm.weight"]),
    }
    for i in range(num_layers):
        b, p = f"{prefix}.block.{i}", f"layers.{i}"
        for proj in ("q", "k", "v", "o"):
            out[f"{p}.attn.{proj}.kernel"] = _lin(sd, f"{b}.layer.0.SelfAttention.{proj}")
        out[f"{p}.ln_attn.scale"] = as_tensor(sd[f"{b}.layer.0.layer_norm.weight"])
        ff = f"{b}.layer.1.DenseReluDense"
        for w in ("wi_0", "wi_1", "wo") if f"{ff}.wi_0.weight" in sd else ("wi", "wo"):
            out[f"{p}.ffn.{w}.kernel"] = _lin(sd, f"{ff}.{w}")
        out[f"{p}.ln_ffn.scale"] = as_tensor(sd[f"{b}.layer.1.layer_norm.weight"])
    return out


def import_decoder(sd: Mapping, num_layers: int, num_codebooks: int, prefix: str = "model.decoder") -> StateDict:
    """Reference ``ParlerTTSForCausalLM`` -> the port's ``ParlerDecoder``:
    ``{prefix}.embed_tokens.{k}`` stacked to (K, vocab + 1, hidden), the
    bias-free attention projections (``out_proj`` -> ``o``), the three layer
    norms, ``fc1`` / ``fc2``, the final norm and ``lm_heads.{k}`` stacked to
    (K, hidden, vocab).  A state_dict without ``lm_heads`` gives none, as
    JAX's importer does, and the strict load then names it missing."""
    out = {
        "embed_tokens.embedding": torch.stack([as_tensor(sd[f"{prefix}.embed_tokens.{k}.weight"])
                                               for k in range(num_codebooks)]),
        "final_ln.scale": as_tensor(sd[f"{prefix}.layer_norm.weight"]),
        "final_ln.bias": as_tensor(sd[f"{prefix}.layer_norm.bias"]),
    }
    for i in range(num_layers):
        b, p = f"{prefix}.layers.{i}", f"layers.{i}"
        for ours, theirs in (("self_attn", "self_attn"), ("cross_attn", "encoder_attn")):
            for proj, name in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
                out[f"{p}.{ours}.{proj}.kernel"] = _lin(sd, f"{b}.{theirs}.{name}")
        for ours, theirs in (("ln_self", "self_attn_layer_norm"), ("ln_cross", "encoder_attn_layer_norm"),
                             ("ln_ffn", "final_layer_norm")):
            out[f"{p}.{ours}.scale"] = as_tensor(sd[f"{b}.{theirs}.weight"])
            out[f"{p}.{ours}.bias"] = as_tensor(sd[f"{b}.{theirs}.bias"])
        out[f"{p}.fc1.kernel"] = _lin(sd, f"{b}.fc1")
        out[f"{p}.fc2.kernel"] = _lin(sd, f"{b}.fc2")
    if any(k.startswith("lm_heads.") for k in sd):
        out["lm_heads.kernel"] = torch.stack([_lin(sd, f"lm_heads.{k}") for k in range(num_codebooks)])
    return out


def conv_weight(sd: Mapping, name: str) -> torch.Tensor:
    """A conv weight, weight norm folded: ``{name}.weight`` as it is, else
    ``g * v / ||v||`` from ``weight_g`` / ``weight_v`` or
    ``parametrizations.weight.original0`` / ``original1``, in float64 with
    the norm over every dimension but 0, cast to fp32."""
    if f"{name}.weight" in sd:
        return as_tensor(sd[f"{name}.weight"])
    if f"{name}.weight_g" in sd:
        g, v = sd[f"{name}.weight_g"], sd[f"{name}.weight_v"]
    else:
        g, v = sd[f"{name}.parametrizations.weight.original0"], sd[f"{name}.parametrizations.weight.original1"]
    g, v = as_tensor(g).double(), as_tensor(v).double()
    norm = v.square().sum(dim=tuple(range(1, v.ndim)), keepdim=True).sqrt()
    return (g * v / norm).float()


def _conv(out: StateDict, ours: str, sd: Mapping, theirs: str) -> None:
    out[f"{ours}.weight"] = conv_weight(sd, theirs)
    out[f"{ours}.bias"] = as_tensor(sd[f"{theirs}.bias"])


def import_dac(sd: Mapping, num_down: int = 4, num_up: int = 4, num_codebooks: int = 9) -> StateDict:
    """HF ``transformers.DacModel`` (or weight-normed descript names of its
    layout) -> the port's ``DAC``: ``encoder.conv1`` / ``block.{i}`` /
    ``snake1`` / ``conv2``, the decoder's mirror with ``conv_t1``, and
    ``quantizer.quantizers.{k}.{in_proj, out_proj, codebook}`` stacked over
    the codebooks (the 1x1 projections as ``(in, out)`` kernels)."""
    out: StateDict = {}

    def snake(ours: str, theirs: str) -> None:
        out[f"{ours}.alpha"] = as_tensor(sd[f"{theirs}.alpha"]).reshape(-1)

    def res(ours: str, theirs: str) -> None:
        snake(f"{ours}.snake1", f"{theirs}.snake1")
        _conv(out, f"{ours}.conv1", sd, f"{theirs}.conv1")
        snake(f"{ours}.snake2", f"{theirs}.snake2")
        _conv(out, f"{ours}.conv2", sd, f"{theirs}.conv2")

    _conv(out, "encoder.conv_in", sd, "encoder.conv1")
    for i in range(num_down):
        for r in (1, 2, 3):
            res(f"encoder.blocks.{i}.res{r}", f"encoder.block.{i}.res_unit{r}")
        snake(f"encoder.blocks.{i}.snake", f"encoder.block.{i}.snake1")
        _conv(out, f"encoder.blocks.{i}.conv_down", sd, f"encoder.block.{i}.conv1")
    snake("encoder.snake_out", "encoder.snake1")
    _conv(out, "encoder.conv_out", sd, "encoder.conv2")
    _conv(out, "decoder.conv_in", sd, "decoder.conv1")
    for i in range(num_up):
        snake(f"decoder.blocks.{i}.snake", f"decoder.block.{i}.snake1")
        _conv(out, f"decoder.blocks.{i}.conv_up", sd, f"decoder.block.{i}.conv_t1")
        for r in (1, 2, 3):
            res(f"decoder.blocks.{i}.res{r}", f"decoder.block.{i}.res_unit{r}")
    snake("decoder.snake_out", "decoder.snake1")
    _conv(out, "decoder.conv_out", sd, "decoder.conv2")
    q = [f"quantizer.quantizers.{k}" for k in range(num_codebooks)]
    out["quantizer.codebooks"] = torch.stack([as_tensor(sd[f"{n}.codebook.weight"]) for n in q])
    for proj in ("in_proj", "out_proj"):
        out[f"quantizer.{proj}.kernel"] = torch.stack([conv_weight(sd, f"{n}.{proj}")[:, :, 0].T for n in q])
        out[f"quantizer.{proj}.bias"] = torch.stack([as_tensor(sd[f"{n}.{proj}.bias"]) for n in q])
    return out


def import_encodec(sd: Mapping, cfg: EncodecConfig) -> StateDict:
    """HF ``transformers.EncodecModel`` -> the port's ``Encodec``.  HF's
    flat ``encoder.layers.{i}`` / ``decoder.layers.{i}`` lists interleave
    parameter-free ELUs, so they are walked with the loop HF builds them
    with; each conv is ``{i}.conv`` (weight norm folded) with ``{i}.norm``
    under ``time_group_norm``; each LSTM's four tensors per layer are
    copied; the codebooks are ``quantizer.layers.{k}.codebook.embed``."""
    out: StateDict = {}
    group_norm = cfg.norm_type == "time_group_norm"

    def conv(ours: str, theirs: str) -> None:
        _conv(out, ours, sd, f"{theirs}.conv")
        if group_norm:
            out[f"{ours}.norm.scale"] = as_tensor(sd[f"{theirs}.norm.weight"])
            out[f"{ours}.norm.bias"] = as_tensor(sd[f"{theirs}.norm.bias"])

    def res(ours: str, theirs: str) -> None:
        conv(f"{ours}.conv1", f"{theirs}.block.1")  # block = [ELU, conv, ELU, conv]
        conv(f"{ours}.conv2", f"{theirs}.block.3")
        if cfg.use_conv_shortcut:
            conv(f"{ours}.shortcut", f"{theirs}.shortcut")

    def lstm(ours: str, theirs: str) -> None:
        for k in range(cfg.num_lstm_layers):
            for name in (f"weight_ih_l{k}", f"weight_hh_l{k}", f"bias_ih_l{k}", f"bias_hh_l{k}"):
                out[f"{ours}.{name}"] = as_tensor(sd[f"{theirs}.lstm.{name}"])

    conv("encoder.conv_in", "encoder.layers.0")
    i = 1
    for b in range(len(cfg.upsampling_ratios)):
        for j in range(cfg.num_residual_layers):
            res(f"encoder.blocks.{b}.res.{j}", f"encoder.layers.{i}")
            i += 1
        i += 1  # ELU
        conv(f"encoder.blocks.{b}.conv_down", f"encoder.layers.{i}")
        i += 1
    lstm("encoder.lstm", f"encoder.layers.{i}")
    conv("encoder.conv_out", f"encoder.layers.{i + 2}")  # after the LSTM and an ELU

    conv("decoder.conv_in", "decoder.layers.0")
    lstm("decoder.lstm", "decoder.layers.1")
    i = 2
    for b in range(len(cfg.upsampling_ratios)):
        i += 1  # ELU
        conv(f"decoder.blocks.{b}.conv_up", f"decoder.layers.{i}")
        i += 1
        for j in range(cfg.num_residual_layers):
            res(f"decoder.blocks.{b}.res.{j}", f"decoder.layers.{i}")
            i += 1
    conv("decoder.conv_out", f"decoder.layers.{i + 1}")  # after an ELU
    out["quantizer.codebooks"] = torch.stack([as_tensor(sd[f"quantizer.layers.{k}.codebook.embed"])
                                              for k in range(cfg.num_quantizers)])
    return out


def strip_prefix(sd: Mapping, prefix: str) -> dict:
    """The entries under ``prefix.``, with it removed."""
    pl = prefix + "."
    return {k[len(pl):]: v for k, v in sd.items() if k.startswith(pl)}
