"""K9, the port's LayerNorm and RMSNorm on the card (``ops/norm.py``,
``csrc/norm.cu``).

On the CPU: ``ops/nn.py``'s ``layer_norm`` and ``rms_norm`` keep the plain
chains (CPU tensors, fp32 activations, autograd), their outputs and
gradients unchanged, with no launch counted; the wrapper's refusals before
any library is loaded, the device last; the build's route to
``csrc/norm.cu``; and the norm sites one decode step of each block family
runs, and the norm sites of an eager prefill, each on rows K9 takes,
which the card's captured steps and prefills must launch K9 for.

On the card (marked ``cuda``; the file imports no JAX, so it runs there
with ``--noconftest``): K9 against the plain chain at every shape the
cells send, at least 99.9 % of the elements equal and the rest within one
bf16 ulp (fp32 statistics summed in another order may round the other way
at a tie), or, for a LayerNorm whose terms nearly cancel, within 2^-16 of
the terms (``_over_tolerance``); a row with a large mean against a
small spread; and each family's captured decode step tallying one
``norm`` launch per norm site.
"""

from __future__ import annotations

import dataclasses
import shutil
import subprocess

import pytest
import torch
import torch.nn.functional as F

from parler_tts_tpu_torch.core import config as C
from parler_tts_tpu_torch.core import graphs as pgraphs
from parler_tts_tpu_torch.generation import generate as G
from parler_tts_tpu_torch.models import parler as pparler
from parler_tts_tpu_torch.ops import cuda_build
from parler_tts_tpu_torch.ops import nn as pnn
from parler_tts_tpu_torch.ops import norm as pnorm

torch.set_num_threads(1)  # tier-1 runs several pytest workers

SMALL_ENCODEC = dict(num_codebooks=4, num_filters=4, hidden_size=16, codebook_dim=16, target_bandwidths=(1.5, 3.0))


def _parent_layer_norm(x, scale, bias, eps):
    """The chain ``ops/nn.py::layer_norm`` ran before K9, as it was."""
    return F.layer_norm(x.float(), x.shape[-1:], scale.float(), bias.float(), eps).to(x.dtype)


def _parent_rms_norm(x, scale, eps):
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def _inputs(rows: int, width: int, dtype=torch.bfloat16, weights=torch.float32, device="cpu", seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((rows, width), generator=gen) * 3 + torch.randn((rows, 1), generator=gen)
    scale = 1 + 0.2 * torch.randn(width, generator=gen)
    bias = 0.1 * torch.randn(width, generator=gen)
    return x.to(device, dtype), scale.to(device, weights), bias.to(device, weights)


# --- off the card ------------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["layer", "rms"])
@pytest.mark.parametrize("case", ["bf16", "fp32", "bf16_weights", "autograd", "no_grad", "three_dims"])
def test_norms_off_the_card_keep_the_plain_chain(monkeypatch, kind, case):
    """CPU tensors (bf16 or fp32 activations, fp32 or bf16 weights, under
    autograd or not) take the plain chain: the parent's outputs and
    gradients bit for bit, and no K9 launch."""
    monkeypatch.setattr(pnorm, "norm_cuda", lambda *a: pytest.fail("K9 called off the card"))
    before = pgraphs.launches()["norm"]
    x, scale, bias = _inputs(5, 48, dtype=torch.float32 if case == "fp32" else torch.bfloat16,
                             weights=torch.bfloat16 if case == "bf16_weights" else torch.float32)
    if case == "three_dims":
        x = x.view(5, 3, 16)
        scale, bias = scale[:16], bias[:16]
    if case == "autograd":
        scale.requires_grad_()
        bias.requires_grad_()
    ours = (lambda *a: pnn.layer_norm(*a, eps=1e-5)) if kind == "layer" else (lambda x, s, b: pnn.rms_norm(x, s))
    parent = (lambda *a: _parent_layer_norm(*a, 1e-5)) if kind == "layer" else (
        lambda x, s, b: _parent_rms_norm(x, s, 1e-6))
    with torch.no_grad() if case == "no_grad" else torch.enable_grad():
        got = ours(x, scale, bias)
    want = parent(x, scale, bias)
    assert got.dtype == x.dtype and got.shape == x.shape
    assert torch.equal(got, want)
    if case == "autograd":
        got.float().square().sum().backward()
        grads = [scale.grad.clone()] + ([bias.grad.clone()] if kind == "layer" else [])
        scale.grad = bias.grad = None
        want.float().square().sum().backward()
        assert all(torch.equal(g, w) for g, w in zip(grads, [scale.grad, bias.grad]))
    assert pgraphs.launches()["norm"] == before


@pytest.mark.parametrize("case,error,match", [
    ("cpu", ValueError, "CUDA tensors"),
    ("fp32", TypeError, "bf16"),
    ("fp16", TypeError, "bf16"),
    ("scalar", ValueError, "one dimension"),
    ("width_not_8", ValueError, "multiple of 8"),
    ("too_wide", ValueError, "multiple of 8"),
    ("non_contiguous", ValueError, "contiguous"),
    ("off_boundary", ValueError, "16-byte"),
    ("scale_shape", ValueError, "scale"),
    ("scale_fp16", ValueError, "scale"),
    ("bias_dtype", ValueError, "bias"),
    ("needs_grad", RuntimeError, "no backward"),
    ("x_needs_grad", RuntimeError, "no backward"),
])
def test_wrapper_refuses_before_loading_a_library(monkeypatch, case, error, match):
    monkeypatch.setattr(cuda_build, "library", lambda *a, **k: pytest.fail("a library was loaded"))
    before = pgraphs.launches()["norm"]
    x, scale, bias = _inputs(4, 64)
    if case == "fp32":
        x = x.float()
    elif case == "fp16":
        x = x.half()
    elif case == "scalar":
        x = x[0, 0]
    elif case == "width_not_8":
        x, scale, bias = x[:, :60].contiguous(), scale[:60], bias[:60]
    elif case == "too_wide":
        x, scale, bias = _inputs(2, pnorm.MAX_WIDTH + 8)
    elif case == "non_contiguous":
        x = _inputs(64, 4)[0].t()
    elif case == "off_boundary":
        x = _inputs(1, 4 * 64 + 8)[0].view(-1)[1:257].view(4, 64)
    elif case == "scale_shape":
        scale = scale[:32]
    elif case == "scale_fp16":
        scale, bias = scale.half(), bias.half()
    elif case == "bias_dtype":
        bias = bias.bfloat16()
    elif case == "needs_grad":
        scale.requires_grad_()
    elif case == "x_needs_grad":
        x.requires_grad_()
    with pytest.raises(error, match=match):
        pnorm.norm_cuda(x, scale, bias, 1e-5)
    assert not pnorm.takes(x, scale, bias)
    assert pgraphs.launches()["norm"] == before


def test_the_build_takes_norm_from_csrc(monkeypatch, tmp_path):
    """``library("norm")`` resolves to ``libnorm.so`` under a hash that
    covers ``csrc/norm.cu``, and is compiled from that source."""
    lib = cuda_build._library_path("norm")
    assert lib.name == "libnorm.so" and lib.parent.parent == cuda_build.BUILD_ROOT
    copy = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, copy)
    assert cuda_build._library_path("norm", copy) == lib
    (copy / "norm.cu").write_text((copy / "norm.cu").read_text() + "\n// edited\n")
    assert cuda_build._library_path("norm", copy) != lib

    started = []

    class Proc:
        returncode = 1

        def __init__(self, cmd, **kw):
            started.append(cmd)

        def communicate(self):
            return "stand-in compiler", None

    monkeypatch.setattr(cuda_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", Proc)
    with pytest.raises(RuntimeError, match="norm: nvcc exited 1"):
        cuda_build.build(["norm"], copy)
    assert len(started) == 1 and started[0][-1] == str(copy / "norm.cu")


# --- the norm sites of a decode step ----------------------------------------------------------------


def _parler_cfg() -> C.ParlerTTSConfig:
    return C.dummy_config(4)


def _lfm2_cfg() -> C.ParlerTTSConfig:
    """Small, at widths the card's kernels take (K5 at head dim 64, groups
    of 4)."""
    base = C.dummy_config(4)
    dec = C.DecoderConfig(vocab_size=1088, hidden_size=512, num_hidden_layers=4, num_attention_heads=8,
                          num_codebooks=4, max_position_embeddings=1024, block_type="lfm2",
                          layer_types=("conv", "full_attention", "conv", "full_attention"), num_key_value_heads=2,
                          num_experts=8, num_experts_per_tok=2, moe_intermediate_size=32, num_dense_layers=1,
                          intermediate_size=96, use_expert_bias=True)
    return dataclasses.replace(base, vocab_size=512, audio_encoder=C.EncodecConfig(**SMALL_ENCODEC), decoder=dec)


def _nemotron_h_cfg() -> C.ParlerTTSConfig:
    """Small, at widths the card's kernels take (K5 at head dim 128, K8 at
    a state of 64), a share of the experts held."""
    base = C.dummy_config(4)
    dec = C.DecoderConfig(vocab_size=1088, hidden_size=256, num_hidden_layers=7, num_attention_heads=8,
                          num_codebooks=4, max_position_embeddings=1024, block_type="nemotron_h",
                          layer_types=C.nemotron_h_layer_types("MEM*EME"), num_key_value_heads=2, num_experts=8,
                          num_experts_per_tok=2, moe_intermediate_size=64, use_expert_bias=True,
                          routed_scaling_factor=2.5, attention_head_dim=128, mamba_num_heads=4, mamba_head_dim=16,
                          ssm_state_size=64, mamba_n_groups=2, use_conv_bias=True, chunk_size=16,
                          moe_shared_expert_intermediate_size=96, experts_held=4, first_expert=2)
    return dataclasses.replace(base, vocab_size=512, audio_encoder=C.EncodecConfig(**SMALL_ENCODEC), decoder=dec)


FAMILIES = {"parler": _parler_cfg, "lfm2": _lfm2_cfg, "nemotron_h": _nemotron_h_cfg}


def norm_sites(cfg: C.ParlerTTSConfig) -> int:
    """The LayerNorms or RMSNorms one decode step runs: Parler's three a
    layer; LFM2's operator, cross and feed-forward norms a layer and q and k
    norms an attention layer; Nemotron-H's one a block and a cross norm an
    attention block (its gated norm is no ``rms_norm``); and the final
    norm.  Mini: 73; LFM2-8B-A1B: 85; Nemotron-3-Nano: 59."""
    dec = cfg.decoder
    attention = sum(t in ("full_attention", "attention") for t in dec.layer_types or ())
    per_layer = {"musicgen": 3, "lfm2": 3, "nemotron_h": 1}[dec.block_type]
    per_attention = {"musicgen": 0, "lfm2": 2, "nemotron_h": 1}[dec.block_type]
    return per_layer * dec.num_hidden_layers + per_attention * attention + 1


def prefill_norm_sites(cfg: C.ParlerTTSConfig) -> int:
    """The norms one prefill runs: T5's two a layer and its final one, and
    the decoder's ``norm_sites`` once over the prompt.  Mini: 98."""
    return 2 * cfg.text_encoder.num_layers + 1 + norm_sites(cfg)


def test_norm_sites_of_the_cells():
    assert norm_sites(C.mini_600m_config()) == 73
    assert norm_sites(C.lfm2_8b_a1b_config()) == 85
    assert norm_sites(C.nemotron_3_nano_30b_a3b_config()) == 59
    assert prefill_norm_sites(C.mini_600m_config()) == 98


def _generation_inputs(rows: int, device) -> dict:
    g = torch.Generator().manual_seed(3)
    inputs = dict(input_ids=torch.randint(3, 500, (rows, 11), generator=g),
                  attention_mask=torch.ones((rows, 11), dtype=torch.int32),
                  prompt_input_ids=torch.randint(3, 500, (rows, 9), generator=g),
                  prompt_attention_mask=torch.ones((rows, 9), dtype=torch.int32))
    inputs["attention_mask"][1, 7:] = 0
    return {k: v.to(device) for k, v in inputs.items()}


def _record_norms(monkeypatch) -> list[torch.Tensor]:
    """Every x ``ops/nn.py``'s ``layer_norm`` and ``rms_norm`` are given
    from now on (they still run)."""
    calls = []
    for name in ("layer_norm", "rms_norm"):
        plain = getattr(pnn, name)
        monkeypatch.setattr(pnn, name, lambda x, *a, _plain=plain, **k: calls.append(x) or _plain(x, *a, **k))
    return calls


def _k9_layout(x: torch.Tensor) -> bool:
    """Rows as K9 takes them: contiguous, on a 16-byte boundary."""
    return x.is_contiguous() and x.data_ptr() % 16 == 0


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_an_eager_decode_step_runs_one_norm_a_site(monkeypatch, family):
    """One eager decode step on the CPU calls ``layer_norm`` or
    ``rms_norm`` ``norm_sites`` times, all on the plain chain, each on rows
    K9 would take on the card."""
    cfg = FAMILIES[family]()
    model = pparler.init(0, cfg, device="cpu")
    gen = C.GenerationConfig(do_sample=False)
    s = G.prefill(model, gen, max_length=12, **_generation_inputs(2, "cpu"))
    calls = _record_norms(monkeypatch)
    before = pgraphs.launches()["norm"]
    G.decode_step(model, gen, s)
    assert len(calls) == norm_sites(cfg) and pgraphs.launches()["norm"] == before
    assert all(_k9_layout(x) for x in calls), [tuple(x.stride()) for x in calls if not _k9_layout(x)]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_an_eager_prefill_runs_one_norm_a_site_on_contiguous_rows(monkeypatch, family):
    """An eager prefill over several prompt positions calls the norms
    ``prefill_norm_sites`` times, each on contiguous rows on a 16-byte
    boundary: on the card ``norm_cuda`` raises on any other layout, so no
    site of a bf16 model may hand it a view (LFM2's q and k norms run on
    the projections' (B, T, heads, D) rows, before the transpose)."""
    cfg = FAMILIES[family]()
    model = pparler.init(0, cfg, device="cpu")
    calls = _record_norms(monkeypatch)
    G.prefill(model, C.GenerationConfig(do_sample=False), max_length=12, **_generation_inputs(2, "cpu"))
    assert len(calls) == prefill_norm_sites(cfg)
    assert all(_k9_layout(x) for x in calls), [tuple(x.stride()) for x in calls if not _k9_layout(x)]


# --- on the card --------------------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernel has no CPU mode)")


def _ordered(x: torch.Tensor) -> torch.Tensor:
    """bf16 values as integers in their order, one apart per ulp (both
    zeros 0)."""
    bits = x.contiguous().view(torch.int16).to(torch.int32)
    return torch.where(bits < 0, -(bits & 0x7FFF), bits)


def _agreement(got: torch.Tensor, want: torch.Tensor) -> tuple[float, int]:
    """The share of elements equal, and the largest distance in ulps."""
    ulps = (_ordered(got) - _ordered(want)).abs()
    return float((ulps == 0).float().mean()), int(ulps.max())


def _over_tolerance(got, want, x, scale, bias, eps) -> int:
    """The elements farther from ``want`` than one bf16 ulp of it (2^-8 of
    its binade) or, for a LayerNorm, than 2^-16 of the terms it sums,
    (|x| + |mean|) · rstd · |scale| + |bias| (float64): where they nearly
    cancel the result is small, and the fp32 statistics of either chain
    (a relative error of some 2^-24 · sqrt(width), summed in another order)
    move it by more than one ulp of it.  An RMSNorm's result is a product,
    so one ulp is its whole tolerance."""
    err = (got.double() - want.double()).abs()
    _, exponent = torch.frexp(want.double())
    allowed = torch.ldexp(torch.ones_like(err), exponent - 8)
    if bias is not None:
        x64 = x.double()
        mean, var = x64.mean(-1, keepdim=True), x64.var(-1, unbiased=False, keepdim=True)
        terms = (x64.abs() + mean.abs()) * torch.rsqrt(var + eps) * scale.double().abs() + bias.double().abs()
        allowed = torch.maximum(allowed, 2.0**-16 * terms)
    return int((err > allowed).sum())


# (kind, rows, width): the cells' norms at their decode steps and T5's in their prefills, then a width of
# each of the kernel's row mappings (one lane to four warps a row, up to the widest row it takes)
CARD_SHAPES = [
    ("layer", 96, 1024),  # the Parler decoder (mini, EnCodec)
    ("rms", 192, 2048),  # LFM2's operator, cross, FFN and final norms
    ("rms", 6144, 64),  # LFM2's q norms (192 rows x 32 heads)
    ("rms", 1536, 64),  # LFM2's k norms (192 rows x 8 K/V heads)
    ("rms", 128, 2688),  # Nemotron-H's block, cross and final norms
    ("rms", 6144, 768),  # T5 (96 rows x 64 description tokens)
    ("layer", 96 * 33, 1024),  # a decoder prefill
    ("layer", 7, 8), ("rms", 5, 16), ("layer", 33, 40), ("rms", 9, 136), ("layer", 3, 256), ("rms", 3, 520),
    ("layer", 5, 512), ("layer", 3, 1032), ("rms", 3, 2056), ("rms", 2, 3072), ("layer", 2, 3072),
]


@pytest.mark.cuda
@pytest.mark.parametrize("weights", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind,rows,width", CARD_SHAPES)
def test_norm_kernel_matches_the_plain_chain(cuda, kind, rows, width, weights):
    x, scale, bias = _inputs(rows, width, weights=weights, device="cuda", seed=rows + width)
    before = pgraphs.launches()["norm"]
    if kind == "layer":
        eps, got, want = 1e-5, pnorm.norm_cuda(x, scale, bias, 1e-5), pnorm.layer_norm_plain(x, scale, bias, 1e-5)
    else:
        bias = None
        eps, got, want = 1e-6, pnorm.norm_cuda(x, scale, None, 1e-6), pnorm.rms_norm_plain(x, scale, 1e-6)
    torch.cuda.synchronize()
    assert pgraphs.launches()["norm"] == before + 1
    equal, ulps = _agreement(got, want)
    over = _over_tolerance(got, want, x, scale, bias, eps)
    assert equal >= 0.999 and over == 0, (equal, ulps, over)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1024, 2688])
def test_norm_kernel_takes_a_large_mean_against_a_small_spread(cuda, width):
    """Rows at 32,640 with a spread of one bf16 ulp (128) either way, the
    largest mean against the smallest spread bf16 can hold: a variance taken
    as E[x^2] - mean^2 in fp32 loses percents of it to cancellation; the
    two-pass variance keeps every element within ``_over_tolerance`` of the
    plain chain (Welford's, in ``F.layer_norm``) and of a float64
    LayerNorm (its terms' share covers the fp32 mean's own rounding, which
    moves the outputs of x near the mean by more than an ulp of them)."""
    gen = torch.Generator().manual_seed(width)
    steps = torch.randint(-1, 2, (64, width), generator=gen).float()
    x = (32640 + 128 * steps).to("cuda", torch.bfloat16)
    assert torch.equal(x.float().cpu(), 32640 + 128 * steps)  # every value exact in bf16 (a multiple of its ulp)
    scale = torch.ones(width, device="cuda", dtype=torch.bfloat16)
    bias = torch.zeros(width, device="cuda", dtype=torch.bfloat16)
    got = pnorm.norm_cuda(x, scale, bias, 1e-5)
    exact = F.layer_norm(x.double(), (width,), eps=1e-5).to(torch.bfloat16)
    for want in (pnorm.layer_norm_plain(x, scale, bias, 1e-5), exact):
        assert _over_tolerance(got, want, x, scale, bias, 1e-5) == 0


@pytest.mark.cuda
def test_norm_kernel_on_the_card_refuses_what_it_does_not_take(cuda):
    x, scale, bias = _inputs(4, 64, device="cuda")
    with pytest.raises(TypeError, match="bf16"):
        pnorm.norm_cuda(x.float(), scale, bias, 1e-5)
    with pytest.raises(ValueError, match="scale"):
        pnorm.norm_cuda(x, scale.cpu(), bias, 1e-5)
    transposed = _inputs(64, 8, device="cuda")[0].t()
    with pytest.raises(ValueError, match="contiguous"):
        pnorm.norm_cuda(transposed, scale[:64], None, 1e-6)
    # a bf16 norm on the card is K9's whatever its layout: one K9 cannot take raises, never runs the plain chain
    assert pnorm.takes(transposed, scale[:64])
    with torch.no_grad(), pytest.raises(ValueError, match="contiguous"):
        pnn.rms_norm(transposed, scale[:64])
    assert pnorm.norm_cuda(x[:0], scale, bias, 1e-5).shape == (0, 64)
    assert pnorm.takes(x, scale, bias) and pnorm.takes(x, scale.bfloat16())
    assert not pnorm.takes(x.float(), scale, bias)
    with torch.enable_grad():
        assert not pnorm.takes(x, scale.requires_grad_(), bias)
    with torch.no_grad():
        assert pnorm.takes(x, scale, bias)


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_a_captured_decode_step_launches_k9_once_a_norm_site(cuda, family):
    """A bf16 model of each family on the captured route: every captured
    step program tallies ``norm_sites`` launches of K9 and the captured
    prefill ``prefill_norm_sites``, so each replayed step and prefill
    launches it once a site, and a second call's launches grow by that per
    replayed step plus its replayed prefill's tally."""
    from parler_tts_tpu_torch.utils import profiling

    cfg = FAMILIES[family]()
    model = pparler.init(0, cfg, device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():  # no special id but EOS: the rows run their length
        model.decoder.lm_heads.kernel[..., cfg.audio_encoder.codebook_size + 1:] = 0
    gen = C.GenerationConfig(do_sample=False)
    inputs = _generation_inputs(3, "cuda")
    G.generate_tokens(model, gen, max_length=40, **inputs)  # captures
    captured = list(G._programs_of(model)._by_key.values())
    steps = [p for c in captured for p in c.steps.values()]
    prefills = [p.program for c in captured for p in c.prefills.values()]
    assert steps and all(p.launches["norm"] == norm_sites(cfg) for p in steps)
    launches = pgraphs.launches()["norm"]
    replays = {k: profiling.counters().get(k, 0) for k in ("decode.replays", "prefill.replays")}
    G.generate_tokens(model, gen, max_length=40, **inputs)
    moved = {k: profiling.counters().get(k, 0) - n for k, n in replays.items()}
    assert moved["decode.replays"] > 0 and moved["prefill.replays"] == len(prefills) == 1
    assert prefills[0].launches["norm"] == prefill_norm_sites(cfg)
    assert pgraphs.launches()["norm"] - launches == (norm_sites(cfg) * moved["decode.replays"]
                                                     + prefill_norm_sites(cfg))
