"""The port's DAC encode side and offline audio tokenization against the JAX
package at fp32 on CPU (and a bf16 encode against JAX's bf16 encode, with
the Snake each side of the codec takes): encoder latents, the residual quantizer's codes
(equal except at near-ties, which are counted), ``pad_audio``, the weight
carry-over of the encode side, ``tokenize_audio_batches``, ``CodesCache``
(each package reads the other's part files) and ``parse_dataset_spec``.

The codec is Mini's DAC with its strides (2, 4, 8, 8) and hop 512 at narrow
widths, so the JAX init stays quick."""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parler_tts_tpu.core import config as jcfg
from parler_tts_tpu.generation import generate as jgenerate
from parler_tts_tpu.models import codec as jcodec
from parler_tts_tpu.models import dac as jdac
from parler_tts_tpu.training import data as jdata
from parler_tts_tpu_torch.core import config as pcfg
from parler_tts_tpu.ops.nn import astype_tree
from parler_tts_tpu_torch.core.from_jax import load_jax_params
from parler_tts_tpu_torch.generation import generate as pgenerate
from parler_tts_tpu_torch.models import codec as pcodec
from parler_tts_tpu_torch.models import dac as pdac
from parler_tts_tpu_torch.training import data as pdata
from tests.test_torch_blocks import T, jax_init, jax_params, port_model, tiny_config
from tests.test_torch_generate import SPECIALS, _batch

torch.set_num_threads(1)  # tier-1 runs several pytest workers

LATENT_RTOL = 1e-4  # relative Frobenius error of the encoder's latents
# a code may differ from JAX's only where the port's score of JAX's code is
# within this of its best (scores of unit vectors lie in [-1, 3])
CODE_TIE_TOL = 1e-4
# bf16 encodes in both packages: bf16's unit roundoff bounds the latents'
# relative error and the score gap of a code taken at a near-tie
BF16_LATENT_RTOL = 2.0**-8
BF16_CODE_TIE_TOL = 2.0**-8
WIDTHS = dict(num_codebooks=9, codebook_size=64, codebook_dim=8, latent_dim=64, encoder_hidden_size=8,
              decoder_hidden_size=32)


def narrow_dac(mod):
    return mod.DACConfig(**WIDTHS)


@pytest.fixture(scope="module")
def codecs():
    params = jax_init(jdac.init, narrow_dac(jcfg), 4)
    codec = pdac.DAC(narrow_dac(pcfg))
    load_jax_params(codec, params)
    return params, codec


def _audio(b: int, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 44100
    tone = np.sin(2 * np.pi * rng.uniform(80, 400, (b, 1)) * t)
    return (0.3 * tone + 0.05 * rng.standard_normal((b, n))).astype(np.float32)


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(a)))


@pytest.mark.parametrize("n", [4410, 5000, 512 * 20])
def test_encoder_latents_match_jax(codecs, n):
    """Lengths that are and are not a multiple of the hop."""
    params, codec = codecs
    audio = _audio(2, n, seed=n)
    ref = jdac.encoder_forward(params["encoder"], narrow_dac(jcfg), jdac.pad_audio(audio, 512))
    with torch.no_grad():
        got = codec.encoder(pdac.pad_audio(T(audio), 512)[:, None]).transpose(1, 2)
    assert got.shape == ref.shape == (2, -(-n // 512), WIDTHS["latent_dim"])
    assert _rel(ref, got.numpy()) <= LATENT_RTOL


@pytest.mark.parametrize("n_quantizers", [None, 4])
def test_codes_match_jax_except_at_near_ties(codecs, n_quantizers):
    """Each code the port gives that JAX does not must be a near-tie: the
    port's score of JAX's code within CODE_TIE_TOL of its best.  The tie
    count is reported (0 on this machine's runs)."""
    params, codec = codecs
    audio = _audio(3, 512 * 40 + 77, seed=1)
    ref = np.asarray(jdac.encode(params, narrow_dac(jcfg), audio, n_quantizers=n_quantizers))
    got = pcodec.encode(codec, T(audio), n_quantizers=n_quantizers)
    assert got.dtype == torch.int32 and got.shape == ref.shape == (3, n_quantizers or 9, 41)
    z = codec.encoder(pdac.pad_audio(T(audio), 512)[:, None]).transpose(1, 2)
    gaps = codec.quantizer.code_gaps(z, T(ref))
    ties = int((got.numpy() != ref).sum())
    print(f"codes differing from JAX's (near-ties): {ties} of {ref.size}")
    assert float(gaps.max()) <= CODE_TIE_TOL
    assert float(codec.quantizer.code_gaps(z, got).max()) == 0.0  # the port's own codes are its argmax


def test_code_gaps_see_a_wrong_code(codecs):
    """A code moved off the argmax shows a gap far above the tie tolerance."""
    _, codec = codecs
    z = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 6, WIDTHS["latent_dim"])).astype(np.float32))
    codes = codec.quantizer.encode(z)
    wrong = codes.clone()
    wrong[0, 0, 3] = (wrong[0, 0, 3] + 1) % WIDTHS["codebook_size"]
    gaps = codec.quantizer.code_gaps(z, wrong)
    assert float(gaps[0, 0, 3]) > 100 * CODE_TIE_TOL and float(codec.quantizer.code_gaps(z, codes).max()) == 0.0


def test_pad_audio_matches_jax():
    x = np.arange(2 * 1030, dtype=np.float32).reshape(2, 1030)
    for hop in (512, 8, 1030):
        np.testing.assert_array_equal(pdac.pad_audio(T(x), hop).numpy(), np.asarray(jdac.pad_audio(x, hop)))


def test_load_jax_params_fills_the_encode_side(codecs):
    """Every encoder and in_proj leaf is carried (none skipped), convs in
    torch's layout."""
    params, codec = codecs
    conv = params["encoder"]["blocks"][2]["conv_down"]["kernel"]
    np.testing.assert_array_equal(codec.encoder.blocks[2].conv_down.weight.detach().numpy(),
                                  np.transpose(conv, (2, 1, 0)))
    np.testing.assert_array_equal(codec.quantizer.in_proj.kernel.detach().numpy(),
                                  params["quantizer"]["in_proj"]["kernel"])
    names = {n for n, _ in codec.named_parameters()}
    assert {n for n in names if n.startswith("encoder.")} and "quantizer.in_proj.bias" in names


def test_reset_parameters_draws_the_encode_side_as_jax_init():
    """Unit alphas, zero biases, 0.02 * truncnormal(-2, 2) kernels; the
    decode side's draws come first, so they do not depend on the encode
    side."""
    cfg = narrow_dac(pcfg)
    codec = pdac.DAC(cfg)
    codec.reset_parameters(torch.Generator().manual_seed(0))
    w = codec.encoder.blocks[3].res1.conv1.weight.detach()
    assert float(w.abs().max()) <= 0.04 and 0.012 < float(w.std()) < 0.02
    assert torch.equal(codec.encoder.snake_out.alpha, torch.ones_like(codec.encoder.snake_out.alpha))
    assert not codec.quantizer.in_proj.bias.any() and not codec.encoder.conv_in.bias.any()
    other = pdac.DAC(cfg)
    with torch.no_grad():
        for p in other.encoder.parameters():
            p.fill_(7.0)
    other.reset_parameters(torch.Generator().manual_seed(0))
    for (name, a), (_, b) in zip(codec.named_parameters(), other.named_parameters()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("kw", [dict(batch_size=2), dict(batch_size=3, pad_to_seconds=0.2)])
def test_tokenize_audio_batches_matches_jax(codecs, kw):
    """ceil(len / hop) frames of int16 codes per waveform, as JAX's."""
    params, codec = codecs
    lengths = (3000, 512 * 7, 6001, 1100, 4096)
    waves = [_audio(1, n, seed=n)[0] for n in lengths]
    ref = jdata.tokenize_audio_batches(params, narrow_dac(jcfg), waves, **kw)
    got = pdata.tokenize_audio_batches(codec, narrow_dac(pcfg), waves, **kw)
    assert len(got) == len(ref) == len(waves)
    for g, r, n in zip(got, ref, lengths):
        assert g.dtype == r.dtype == np.int16 and g.shape == r.shape == (9, -(-n // 512))
        np.testing.assert_array_equal(g, r)


def test_codes_cache_reads_each_others_parts(tmp_path):
    """Part file names, keys and int16 codes are the JAX package's: the port
    reads a JAX-written cache and JAX reads the port's."""
    rng = np.random.default_rng(5)
    codes = {i: rng.integers(0, 1024, (9, 5 + i)).astype(np.int32) for i in range(6)}
    jc = jdata.CodesCache(str(tmp_path), split="train", process_index=1, process_count=2)
    for i in (1, 3):
        jc.put(i, codes[i])
    jc.flush()
    pc = pdata.CodesCache(str(tmp_path), split="train")
    for i in (1, 3):
        np.testing.assert_array_equal(pc.get(i), codes[i].astype(np.int16))
        assert pc.get(i).dtype == np.int16
    assert pc.get(0) is None
    for i in (0, 4):
        pc.put(i, codes[i])
    pc.flush()
    pc.put(5, codes[5])
    pc.flush()
    assert sorted(p.name for p in (tmp_path / "train_codes").iterdir()) == [
        "h0of1_part000000.npz", "h0of1_part000001.npz", "h1of2_part000000.npz"]
    again = jdata.CodesCache(str(tmp_path), split="train")
    for i in (0, 1, 3, 4, 5):
        np.testing.assert_array_equal(again.get(i), codes[i].astype(np.int16))
    assert again._part == pdata.CodesCache(str(tmp_path), split="train")._part == 2


@pytest.mark.parametrize("args", [
    ("a+b", "x", "train+test", None, "10+20"), ("a", None, None, "meta", None),
    ("a++c", "x+y+z", None, "m1++m3", "1+2+3"), ("a+b", "x+y+z", None, None, None)])
def test_parse_dataset_spec_matches_jax(args):
    try:
        ref = jdata.parse_dataset_spec(*args)
    except ValueError:
        with pytest.raises(ValueError, match="mismatch"):
            pdata.parse_dataset_spec(*args)
        return
    got = pdata.parse_dataset_spec(*args)
    assert [vars(g) for g in got] == [vars(r) for r in ref]


def test_codec_encode_refuses_encodec_and_runs_tiny():
    """The dispatch encodes DAC (the tiny composite's codec too) and builds an
    EnCodec for an EnCodec config, whose composite encode refuses a
    normalized one, as JAX's does."""
    cfg = tiny_config(pcfg).audio_encoder
    codec = pcodec.build(cfg)
    codec.reset_parameters(torch.Generator().manual_seed(1))
    codes = pcodec.encode(codec, torch.zeros(2, 100))
    assert codes.shape == (2, cfg.num_codebooks, -(-100 // cfg.hop_length))
    assert jcodec.is_encodec(jcfg.EncodecConfig()) and pcodec.is_encodec(jcfg.EncodecConfig())
    normalized = pcodec.build(pcfg.EncodecConfig(normalize=True, num_filters=2, hidden_size=8))
    assert type(normalized).__name__ == "Encodec"
    with pytest.raises(ValueError, match="codes-only"):
        pcodec.encode(normalized, torch.zeros(1, 640))
    with pytest.raises(ValueError, match="codes-only"):
        jcodec.encode(None, jcfg.EncodecConfig(normalize=True), np.zeros((1, 640), np.float32))


@pytest.mark.parametrize("side", ["encode", "decode"])
def test_codec_convolutions_run_with_tf32_off_and_restore_the_flag(codecs, side, monkeypatch):
    """cuDNN runs fp32 convolutions in TF32 by default; the codec turns it
    off around its conv stacks (an fp32 codec is fp32, as JAX's offline
    tokenizer is) and leaves the caller's flag as it found it."""
    _, codec = codecs
    seen = []
    stack = codec.encoder if side == "encode" else codec.decoder
    real = stack.forward
    monkeypatch.setattr(stack, "forward", lambda x: seen.append(torch.backends.cudnn.allow_tf32) or real(x))
    for flag in (True, False):
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", flag)
        if side == "encode":
            codec.encode(T(_audio(1, 1024)))
        else:
            codec.decode(torch.zeros((1, 9, 3), dtype=torch.int64))
        assert torch.backends.cudnn.allow_tf32 is flag
    assert seen == [False, False]


def _bf16(audio: np.ndarray):
    """The same bf16 waveform for both packages (JAX's encoder computes in
    the audio's dtype, the port's in the codec's)."""
    jax_audio = jnp.asarray(audio, jnp.bfloat16)
    return jax_audio, torch.from_numpy(np.array(jax_audio.astype(jnp.float32))).to(torch.bfloat16)


def test_bf16_encode_matches_jax_bf16_encode(codecs):
    """A bf16 ``DAC.encode`` against JAX's bf16 ``dac.encode`` on the same
    (bf16-rounded) params: latents within bf16's roundoff, codes equal but
    at near-ties (``code_gaps``), whose count is reported.  The encoder's
    Snakes are the exact ones, as JAX's ``encoder_forward``'s; the
    polynomial (the decoder's bf16 Snake) puts the latents 2.7e-2 away and
    takes codes 1.9e-2 below the best score."""
    params, codec = codecs
    codec = copy.deepcopy(codec).to(torch.bfloat16)
    jax_audio, audio = _bf16(_audio(3, 512 * 40 + 77, seed=1))
    jparams = astype_tree(params, jnp.bfloat16)
    ref = np.asarray(jdac.encode(jparams, narrow_dac(jcfg), jax_audio))
    ref_z = jdac.encoder_forward(jparams["encoder"], narrow_dac(jcfg), jdac.pad_audio(jax_audio, 512))
    got = codec.encode(audio)
    with torch.no_grad():
        z = codec.encoder(pdac.pad_audio(audio, 512)[:, None]).transpose(1, 2)
    assert z.dtype == torch.bfloat16 and got.shape == ref.shape == (3, 9, 41)
    assert _rel(np.asarray(ref_z.astype(jnp.float32)), z.float().numpy()) <= BF16_LATENT_RTOL
    gaps = codec.quantizer.code_gaps(z, T(ref))
    print(f"bf16 codes differing from JAX's (near-ties): {int((got.numpy() != ref).sum())} of {ref.size}")
    assert float(gaps.max()) <= BF16_CODE_TIE_TOL


def test_encoder_snakes_are_exact_and_decoder_snakes_fast(codecs):
    """Every Snake of the encoder is exact at bf16 too; every Snake of the
    decoder is the polynomial at bf16 and exact at fp32."""
    _, codec = codecs
    sides = {side: [m for m in getattr(codec, side).modules() if isinstance(m, pdac.Snake)]
             for side in ("encoder", "decoder")}
    # per block: 3 residual units x 2 + the block's own; + the stack's last
    assert len(sides["encoder"]) == len(sides["decoder"]) == 4 * 7 + 1
    assert not any(m.fast for m in sides["encoder"]) and all(m.fast for m in sides["decoder"])
    x = torch.from_numpy(4 * np.random.default_rng(3).standard_normal((2, 8, 50)).astype(np.float32))
    for side, fn in (("encoder", pdac.snake), ("decoder", pdac.snake_fast)):
        m = copy.deepcopy(sides[side][0]).to(torch.bfloat16)
        m.alpha.data = torch.linspace(0.2, 2.0, 8, dtype=torch.bfloat16)
        xb = x.to(torch.bfloat16)
        assert torch.equal(m(xb), fn(xb, m.alpha)), side
        assert torch.equal(m.float()(x), pdac.snake(x, m.alpha)), side


def test_bf16_generate_from_input_values_matches_jax():
    """Composite ``generate(input_values=...)`` on the tiny model in bf16,
    greedy, against JAX's with bf16 params and waveform: the same frame
    counts and, over each row's valid frames, the same codes (the audio
    prompt's 40 encoded frames and what follows them)."""
    params = jax_params(tiny_config(jcfg), seed=1)
    model = port_model(params).to(torch.bfloat16)
    rng = np.random.default_rng(5)
    hop = tiny_config(pcfg).audio_encoder.hop_length
    wave = (0.3 * np.sin(np.arange(40 * hop) * rng.uniform(0.2, 0.9, (2, 1)))
            + 0.05 * rng.standard_normal((2, 40 * hop))).astype(np.float32)
    jax_wave, torch_wave = _bf16(wave)
    jgen = jcfg.GenerationConfig(max_length=60, **SPECIALS, do_sample=False)
    ref = jgenerate.generate(astype_tree(params, jnp.bfloat16), tiny_config(jcfg), jgen, key=jax.random.PRNGKey(4),
                             input_values=jax_wave, **_batch())
    out = pgenerate.generate(model, pcfg.GenerationConfig.from_dict(jgen.to_dict()), input_values=torch_wave,
                             device="cpu", **_batch())
    lengths = np.asarray(ref.code_lengths)
    np.testing.assert_array_equal(lengths, out.code_lengths.numpy())
    assert lengths.min() > 40
    for row, n in enumerate(lengths):
        np.testing.assert_array_equal(np.asarray(ref.codes)[row, :, :n], out.codes[row, :, :n].numpy())


def test_codec_decode_splits_rows_by_the_sample_budget(codecs, monkeypatch):
    """``models/codec.decode`` vocodes at most ``VOCODE_SAMPLES`` output
    samples per call, in row order: 5 rows of 3 frames under a budget of 2
    such rows decode in 3 calls, as one call would."""
    _, codec = codecs
    codes = torch.from_numpy(np.random.default_rng(9).integers(0, 64, (5, 9, 3)))
    whole = codec.decode(codes)
    calls = []
    real = codec.decode
    monkeypatch.setattr(codec, "decode", lambda c: calls.append(c.shape[0]) or real(c))
    monkeypatch.setattr(pcodec, "VOCODE_SAMPLES", 2 * 3 * 512 + 511)
    split = pcodec.decode(codec, codes)
    assert calls == [2, 2, 1] and split.shape == whole.shape == (5, 3 * 512)
    np.testing.assert_allclose(split.detach().numpy(), whole.detach().numpy(), atol=1e-6, rtol=0)
    calls.clear()
    monkeypatch.setattr(pcodec, "VOCODE_SAMPLES", 1)  # a row longer than the budget still decodes
    pcodec.decode(codec, codes[:2])
    assert calls == [1, 1]
