"""Weights of a configuration, made on the device from the seed.

The benchmark makes the weights itself and hands the same values to the
program under test and to the plain reference.  ``layout`` lists the
parameter names and shapes (read once from the program's module on the
meta device: names and shapes only, never values).  ``make`` draws every
value from one ``torch.Generator`` seeded with ``seed`` in one call, in the
dtype the model is served in, and shapes each tensor by the rule its name
matches.  Called twice with the same seed on the same card it gives the same
values, so the reference regenerates them after the window instead of
keeping a copy beside the program's.

The rules follow the published inits: T5's fan-in-scaled normals,
``initializer_factor`` 0.02 in the decoder and the DAC, unit normal
codebooks, and EnCodec's fan-in-scaled convolutions and LSTM; biases, norm
scales and the DAC's Snake alphas (around 1) are drawn too, not set to the
constants they start from.
The LM-head columns of the special ids (>= the codec's codebook size) are
zeroed: with random weights a special id would end a row within a few
steps, where a trained model decodes to its length.
"""

from __future__ import annotations

import math

import torch

def _encodec(n: str) -> bool:
    return n.startswith("audio_encoder.") and n.split(".")[1] in ("encoder", "decoder")


#: (name test, mean, std or a fan-in rule) by first match; ``encodec`` says
#: whether the codec is EnCodec, whose fan-in init lets the codes through
#: its narrow SEANet (at 0.02 its waveform is its last bias)
RULES = (
    (lambda n, encodec: n.endswith(".alpha"), 1.0, 0.2),  # Snake's, five stds above 0
    (lambda n, encodec: n.endswith(".scale"), 1.0, 0.1),
    (lambda n, encodec: n.rsplit(".", 1)[-1].startswith("bias"), 0.0, 0.02),
    (lambda n, encodec: n == "text_encoder.token_embed.embedding", 0.0, 1.0),
    (lambda n, encodec: n == "text_encoder.rel_attn_bias.embedding", 0.0, 0.1),
    (lambda n, encodec: n.startswith("text_encoder."), 0.0, "in"),  # (in, out) kernels
    (lambda n, encodec: n.endswith("quantizer.codebooks"), 0.0, 1.0),
    (lambda n, encodec: encodec and _encodec(n) and ".conv_up." in n, 0.0, "conv_t"),  # (in, out, 2 stride)
    (lambda n, encodec: encodec and _encodec(n) and ".lstm." in n, 0.0, "lstm"),  # (4 hidden, hidden)
    (lambda n, encodec: encodec and _encodec(n), 0.0, "conv"),  # (out, in, width)
    (lambda n, encodec: True, 0.0, 0.02),
)

#: a fan-in rule's std from a tensor's shape: one over the root of the
#: inputs that sum into one output
FAN_IN = {"in": lambda s: s[0], "conv_t": lambda s: s[0] * 2, "lstm": lambda s: s[1], "conv": lambda s: s[1] * s[2]}


def layout(module: torch.nn.Module) -> list[tuple[str, tuple[int, ...]]]:
    """The (name, shape) of every entry of ``module``'s state dict, in order."""
    return [(name, tuple(t.shape)) for name, t in module.state_dict().items()]


def rule(name: str, shape: tuple[int, ...], encodec: bool) -> tuple[float, float]:
    for test, mean, std in RULES:
        if test(name, encodec):
            return mean, (FAN_IN[std](shape) ** -0.5 if isinstance(std, str) else std)
    raise AssertionError(name)


@torch.no_grad()
def make(seed: int, spec: list[tuple[str, tuple[int, ...]]], *, codebook_size: int,
         device: torch.device | str, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """name -> tensor on ``device`` in ``dtype``, views of one buffer drawn
    by one ``randn`` call from a generator seeded with ``seed``."""
    device = torch.device(device)
    encodec = any(".lstm." in name for name, _ in spec)
    generator = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(shape) for _, shape in spec)
    buf = torch.randn(total, generator=generator, device=device, dtype=dtype)
    out, offset = {}, 0
    for name, shape in spec:
        n = math.prod(shape)
        view = buf[offset:offset + n].view(shape)
        mean, std = rule(name, shape, encodec)
        view.mul_(std).add_(mean)
        out[name] = view
        offset += n
    heads = out.get("decoder.lm_heads.kernel")
    if heads is not None:
        heads[..., codebook_size:] = 0
    return out
