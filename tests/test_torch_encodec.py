"""The port's EnCodec codec family against the JAX package and against
``transformers.EncodecModel`` at fp32 on CPU, on both published variants'
architectures at tiny widths: the 24 kHz style (causal convs, reflect
padding, weight norm, whole-input encode) and the 48 kHz style (non-causal,
``time_group_norm``, stereo, normalized, chunked encode with overlap-add
decode).  ``tests/test_torch_encodec_composite.py`` holds a composite
carrying one."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from parler_tts_tpu.core import config as jcfg
from parler_tts_tpu.core.torch_import import import_encodec as jax_import_encodec
from parler_tts_tpu.models import encodec as jenc
from parler_tts_tpu.training import data as jdata
from parler_tts_tpu_torch.core import config as pcfg
from parler_tts_tpu_torch.core import torch_import as pti
from parler_tts_tpu_torch.core.from_jax import load_jax_params
from parler_tts_tpu_torch.models import codec as pcodec
from parler_tts_tpu_torch.models import encodec as penc
from parler_tts_tpu_torch.training import data as pdata
from tests.test_torch_blocks import T, close, jax_init

torch.set_num_threads(1)  # tier-1 runs several pytest workers

WAVE_TOL = 1e-5  # the JAX package's own tolerance against HF (tests/test_encodec.py)
SCALE_RTOL = 1e-6

TINY_24K = dict(target_bandwidths=[0.1, 0.2, 0.4], sampling_rate=160, audio_channels=1, normalize=False,
                hidden_size=16, num_filters=4, num_residual_layers=1, upsampling_ratios=[4, 2],
                norm_type="weight_norm", codebook_size=32, use_causal_conv=True)
TINY_48K = dict(target_bandwidths=[0.2, 0.4], sampling_rate=160, audio_channels=2, normalize=True,
                chunk_length_s=0.5, overlap=0.25, hidden_size=16, num_filters=4, num_residual_layers=1,
                upsampling_ratios=[4, 2], norm_type="time_group_norm", codebook_size=32, use_causal_conv=False)
VARIANTS = {"24k": TINY_24K, "48k": TINY_48K}


def hf_encodec(kwargs):
    """A random ``transformers.EncodecModel`` with random codebooks (HF
    initialises them to zeros)."""
    from transformers import EncodecConfig as HFEncodecConfig, EncodecModel as HFEncodecModel

    torch.manual_seed(0)
    m = HFEncodecModel(HFEncodecConfig(**kwargs)).eval()
    with torch.no_grad():
        for layer in m.quantizer.layers:
            layer.codebook.embed.normal_(generator=torch.Generator().manual_seed(7))
    return m


def port_codec(cfg, state=None, tree=None) -> penc.Encodec:
    codec = penc.Encodec(cfg)
    if state is not None:
        codec.load_state_dict(state, strict=True)
    else:
        load_jax_params(codec, tree)
    return codec


@pytest.fixture(scope="module")
def from_jax():
    """variant -> (JAX config, JAX params, the port's codec carrying them),
    built once per variant."""
    cache = {}

    def get(variant):
        if variant not in cache:
            jc = jcfg.EncodecConfig(**VARIANTS[variant])
            params = jax_init(jenc.init, jc, 3)
            cache[variant] = jc, params, port_codec(pcfg.EncodecConfig(**VARIANTS[variant]), tree=params)
        return cache[variant]
    return get


@pytest.fixture(scope="module")
def from_hf():
    """variant -> (HF model, the port's codec through its own
    ``import_encodec``), built once per variant."""
    cache = {}

    def get(variant):
        if variant not in cache:
            m = hf_encodec(VARIANTS[variant])
            cfg = pcfg.EncodecConfig(**VARIANTS[variant])
            cache[variant] = m, port_codec(cfg, state=pti.import_encodec(m.state_dict(), cfg))
        return cache[variant]
    return get


def _audio(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(np.float32)


# --- config -------------------------------------------------------------------


@pytest.mark.parametrize("kwargs", [TINY_24K, TINY_48K, {}], ids=["24k", "48k", "encodec_24khz"])
def test_config_properties_match_jax(kwargs):
    j, p = jcfg.EncodecConfig(**kwargs), pcfg.EncodecConfig(**kwargs)
    assert p.to_dict() == j.to_dict()
    for prop in ("hop_length", "frame_rate", "codebook_nbits", "num_quantizers", "chunk_length", "chunk_stride"):
        assert getattr(p, prop) == getattr(j, prop), prop
    if not kwargs:  # facebook/encodec_24khz
        assert (p.hop_length, p.frame_rate, p.num_quantizers, p.codebook_dim) == (320, 75, 32, 128)
    with pytest.raises(ValueError, match="norm_type"):
        pcfg.EncodecConfig(norm_type="batch_norm")


def test_config_json_round_trip_dispatches_on_codec_type(tmp_path):
    """codec_type picks the codec family through the composite's JSON, as the
    JAX package writes it; DAC configs stay DAC."""
    jcfg.ParlerTTSConfig(audio_encoder=jcfg.EncodecConfig(num_codebooks=8)).save(str(tmp_path / "c.json"))
    back = pcfg.ParlerTTSConfig.load(str(tmp_path / "c.json"))
    assert isinstance(back.audio_encoder, pcfg.EncodecConfig)
    assert back == pcfg.ParlerTTSConfig(audio_encoder=pcfg.EncodecConfig(num_codebooks=8))
    assert (back.audio_encoder.num_codebooks, back.frame_rate, back.sampling_rate) == (8, 75, 24000)
    assert pcfg.ParlerTTSConfig.from_dict(pcfg.ParlerTTSConfig().to_dict()).audio_encoder.codec_type == "dac"
    assert isinstance(pcodec.build(back.audio_encoder), penc.Encodec)


def test_large_2b_config_matches_jax():
    assert pcfg.large_2b_config().to_dict() == jcfg.large_2b_config().to_dict()


# --- against JAX --------------------------------------------------------------


def test_encode_codes_equal_jax_for_every_bandwidth_and_pinned(from_jax):
    jc, params, codec = from_jax("24k")
    audio = _audio((2, 67), 0)
    for bw in (*jc.target_bandwidths, None):
        np.testing.assert_array_equal(codec.encode(T(audio), bandwidth=bw).numpy(),
                                      np.asarray(jenc.encode(params, jc, audio, bandwidth=bw)))
    for n_q in (1, 3, jc.num_quantizers):
        got = codec.encode(T(audio), n_quantizers=n_q)
        assert got.dtype == torch.int32 and got.shape == (2, n_q, -(-67 // jc.hop_length))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jenc.encode(params, jc, audio, n_quantizers=n_q)))


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("k", [None, 2])
def test_decode_matches_jax_from_all_or_partial_codebooks(from_jax, variant, k):
    """The RVQ decode sums however many codebooks it is given."""
    jc, params, codec = from_jax(variant)
    k = k or jc.num_quantizers
    codes = np.random.default_rng(1).integers(0, 32, (2, k, 9))
    scales = np.float32([[0.7], [1.3]]) if variant == "48k" else None
    ref = np.asarray(jenc.decode(params, jc, codes, scales=scales))
    got = codec.decode(T(codes), None if scales is None else T(scales))
    assert got.shape == ref.shape == ((2, 72) if variant == "24k" else (2, 72, 2))
    close(ref, got, WAVE_TOL)


def test_48k_chunked_normalized_stereo_matches_jax(from_jax):
    jc, params, codec = from_jax("48k")
    audio = _audio((2, 140, 2), 4)
    # jitted whole: eagerly, XLA compiles each op of the three chunks' stacks on its own
    codes, scales, last_pad = jax.jit(lambda p, x: jenc.encode_chunked(p, jc, x))(params, audio)
    last_pad = int(last_pad)
    got_codes, got_scales, got_pad = codec.encode_chunked(T(audio))
    np.testing.assert_array_equal(got_codes.numpy(), np.asarray(codes))
    assert got_pad == last_pad > 0
    np.testing.assert_allclose(got_scales.numpy(), np.asarray(scales), rtol=SCALE_RTOL)
    ref = np.asarray(jax.jit(lambda p, c, s: jenc.decode_chunked(p, jc, c, scales=s, last_frame_pad_length=last_pad))(
        params, codes, scales))
    close(ref, codec.decode_chunked(got_codes, scales=got_scales, last_frame_pad_length=got_pad), WAVE_TOL)
    with pytest.raises(ValueError, match="chunked"):
        codec.encode(T(audio))


def test_tokenize_audio_batches_with_encodec_matches_jax(from_jax):
    jc, params, codec = from_jax("24k")
    waves = [_audio((n,), n) for n in (50, 64, 13, 77)]
    ref = jdata.tokenize_audio_batches(params, jc, waves, batch_size=3)
    got = pdata.tokenize_audio_batches(codec, codec.cfg, waves, batch_size=3)
    for g, r, n in zip(got, ref, (50, 64, 13, 77)):
        assert g.dtype == np.int16 and g.shape == r.shape == (jc.num_codebooks, -(-n // jc.hop_length))
        np.testing.assert_array_equal(g, r)


# --- against transformers.EncodecModel ----------------------------------------


def test_24k_codes_and_waveforms_equal_hf(from_hf):
    """Every bandwidth's codes, and decode from all or some codebooks."""
    m, codec = from_hf("24k")
    audio = _audio((2, 67), 0)
    for bw in m.config.target_bandwidths:
        with torch.no_grad():
            ref = m.encode(T(audio)[:, None, :], bandwidth=bw).audio_codes[0]
        np.testing.assert_array_equal(codec.encode(T(audio), bandwidth=bw).numpy(), ref.numpy())
    for k in (4, 2):
        codes = np.random.default_rng(k).integers(0, 32, (2, k, 9))
        with torch.no_grad():
            ref = m.decode(T(codes)[None], audio_scales=[None]).audio_values[:, 0]
        close(ref.numpy(), codec.decode(T(codes)), WAVE_TOL)


def test_48k_chunked_normalized_stereo_equals_hf(from_hf):
    m, codec = from_hf("48k")
    audio = _audio((2, 140, 2), 4)
    with torch.no_grad():
        enc = m.encode(T(audio).permute(0, 2, 1))
        ref_wav = m.decode(enc.audio_codes, enc.audio_scales,
                           last_frame_pad_length=enc.last_frame_pad_length).audio_values
    codes, scales, last_pad = codec.encode_chunked(T(audio))
    np.testing.assert_array_equal(codes.numpy(), enc.audio_codes.numpy())
    assert last_pad == enc.last_frame_pad_length
    np.testing.assert_allclose(scales.numpy(), np.stack([s.numpy() for s in enc.audio_scales]), rtol=SCALE_RTOL)
    wav = codec.decode_chunked(codes, scales=scales, last_frame_pad_length=last_pad)
    close(ref_wav.permute(0, 2, 1).numpy(), wav, WAVE_TOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_import_encodec_equals_the_jax_import_carried_over(variant):
    """The port's direct HF import and the JAX importer's tree carried by
    ``from_jax`` give the same parameters: the LSTM biases summed, the
    transposed convs unflipped, weight norm folded within one fp32 ulp."""
    m = hf_encodec(VARIANTS[variant])
    sd = m.state_dict()
    cfg = pcfg.EncodecConfig(**VARIANTS[variant])
    direct = port_codec(cfg, state=pti.import_encodec(sd, cfg))
    carried = port_codec(cfg, tree=jax_import_encodec({k: v.numpy() for k, v in sd.items()},
                                                      jcfg.EncodecConfig(**VARIANTS[variant])))
    theirs = carried.state_dict()
    for name, p in direct.state_dict().items():
        if "bias_" in name and "lstm" in name:
            continue
        torch.testing.assert_close(p, theirs[name], rtol=2**-23, atol=0, msg=name)
    for side in ("encoder", "decoder"):
        lstm, other = getattr(direct, side).lstm, getattr(carried, side).lstm
        torch.testing.assert_close(lstm.bias_ih_l1 + lstm.bias_hh_l1, other.bias_ih_l1, rtol=0, atol=0)
    # the 24 kHz model stores its convs weight-normed, the 48 kHz one plain
    assert ("parametrizations.weight.original0" in " ".join(sd)) == (variant == "24k")


# --- module pieces -------------------------------------------------------------


@pytest.mark.parametrize("t,left,right", [(10, 3, 2), (2, 3, 0), (3, 0, 4), (1, 6, 6)])
def test_pad1d_matches_jax_including_short_inputs(t, left, right):
    x = _audio((2, t, 3), t)
    ref = np.asarray(jenc._pad1d(x, left, right, "reflect"))
    got = penc.pad1d(T(x).transpose(1, 2), left, right, "reflect").transpose(1, 2)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_code_gaps_see_a_wrong_code():
    cfg = pcfg.EncodecConfig(**TINY_24K)
    codec = penc.Encodec(cfg)
    codec.reset_parameters(torch.Generator().manual_seed(0))
    z = torch.from_numpy(_audio((1, 6, cfg.codebook_dim), 2) * 30)
    codes = codec.quantizer.encode(z, cfg.num_quantizers)
    wrong = codes.clone()
    wrong[0, 1, 3] = (wrong[0, 1, 3] + 1) % cfg.codebook_size
    assert float(codec.quantizer.code_gaps(z, codes).max()) == 0.0
    assert float(codec.quantizer.code_gaps(z, wrong)[0, 1, 3]) > 1e-2


def test_reset_parameters_draws_as_jax_init():
    """0.02 * truncnormal(-2, 2) convs, normal(0, 0.02) LSTM matrices, zero
    biases, unit norm scales, normal(0, 1) codebooks; the decode side's
    draws do not depend on the encode side."""
    cfg = pcfg.EncodecConfig(**{**TINY_48K, "num_filters": 16})
    codec = penc.Encodec(cfg)
    codec.reset_parameters(torch.Generator().manual_seed(0))
    w = codec.decoder.blocks[0].conv_up.weight.detach()
    assert float(w.abs().max()) <= 0.04 and 0.012 < float(w.std()) < 0.02
    assert 0.015 < float(codec.encoder.lstm.weight_hh_l0.detach().std()) < 0.025
    assert not codec.encoder.lstm.bias_ih_l1.any() and not codec.decoder.conv_out.bias.any()
    assert torch.equal(codec.encoder.conv_in.norm.scale, torch.ones(16))
    assert 0.9 < float(codec.quantizer.codebooks.detach().std()) < 1.1
    other = penc.Encodec(cfg)
    with torch.no_grad():
        for p in other.encoder.parameters():
            p.fill_(7.0)
    other.reset_parameters(torch.Generator().manual_seed(0))
    for (name, a), (_, b) in zip(codec.named_parameters(), other.named_parameters()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("side", ["encode", "decode"])
def test_encodec_runs_with_tf32_off_and_restores_the_flag(side, monkeypatch):
    """cuDNN runs fp32 convolutions and LSTMs in TF32 by default; the codec
    turns it off around its stacks and restores the caller's flag."""
    codec = penc.Encodec(pcfg.EncodecConfig(**TINY_24K))
    codec.reset_parameters(torch.Generator().manual_seed(0))
    seen = []
    stack = codec.encoder if side == "encode" else codec.decoder
    real = stack.forward
    monkeypatch.setattr(stack, "forward", lambda x: seen.append(torch.backends.cudnn.allow_tf32) or real(x))
    for flag in (True, False):
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", flag)
        if side == "encode":
            codec.encode(torch.zeros(1, 40))
        else:
            codec.decode(torch.zeros((1, 4, 3), dtype=torch.int64))
        assert torch.backends.cudnn.allow_tf32 is flag
    assert seen == [False, False]
