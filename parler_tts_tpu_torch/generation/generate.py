"""Autoregressive generation: description + prompt ids -> codec tokens ->
waveform, decoder-only continuation, and the prefill and step that
streaming shares.

Port of ``parler_tts_tpu/generation/generate.py``, with the same semantics:

* classifier-free guidance runs ``[cond; uncond]`` rows.  With text
  conditioning the uncond rows get zeroed encoder states and a zeroed
  encoder mask and the prompt rows are repeated; without it (``input_ids``
  None: no T5 encode, no cross-attention) the uncond rows get zeroed prompt
  states and a zeroed prompt mask;
* one fused mask covers the prompt (left-padded) followed by every decode
  position;
* the prefill covers the prompt, the BOS frame and any audio-prompt codes
  (``decoder_input_codes``, placed after the BOS frame before the delay
  pattern), then one cached decoder step per position;
* the prefill runs the model's own weights; the steps run the decode view
  (``ParlerDecoder.decode_params``: fused q/k/v, int8 with
  ``gen.int8_weights``) over a cache stored as ``gen.kv_cache_dtype``;
* a finished stream emits PAD, and a stream finishes on its raw sampled EOS,
  before delay forcing (``where(pattern == -1, sampled, forced)``);
* the loop ends early once every ``(batch, codebook)`` stream has finished.

The decode loop is JAX's loop nest.  For each KV-read bucket
(``_kv_read_limits``: fused lengths, at most ``gen.kv_read_buckets``) the
steps below the bucket's end ``t_hi`` run in segments of ``STAGE`` masked
steps, and the host reads whether every stream has finished once per
segment, as JAX's ``make_cond`` does.  A step reads the cache over its
bucket's static length and keeps its new position, tokens, ``finished`` and
logits only where ``(t < t_hi) & ~all(finished)`` holds on the device; a
masked step's cache write lands at the position the next real step
rewrites.  A segment never runs past its bucket's ``t_hi``, so a step is
masked only once every stream has finished: the states a step updates in
place (the LFM2 and Nemotron-H conv states, Nemotron-H's SSM state) are
never moved by a step whose position is not kept while a stream still
reads them.  The host knows ``t`` at each segment's start (it advances by one
per step until every stream has finished), so a bucket's last segment runs
only its ``t_hi - t`` steps, which JAX's fixed-length scan runs masked.  The
loop stops at a given position too (``_decode``'s ``end``, JAX
``run_chunk``'s condition): ``generate_tokens`` runs it to ``max_length``,
a stream once per chunk.

Where the steps run:

* where ``core/graphs.capturable`` (a CUDA model without a model group),
  the JAX package's jitted programs become CUDA graphs, kept per signature
  (rows, prompt and encoder lengths, ``max_length``, the dtype, the
  generation config, injected noise or not, the decoder's weight
  addresses): each bucket's step, replayed ``STAGE``
  times per segment, and the prefill (T5 encode, prompt embedding, CFG
  rows, delay pattern, the decoder prefill with its K1 launches, the first
  logits), one graph per input shape (the audio-prompt frames included).
  The state, cache, masks, the decode view, the sampler's draws and the
  prefill's inputs live in static buffers kept on the model (a
  ``core/graphs.Programs``).  A capture or replay that fails raises:
  nothing falls back to the eager loop;
* on the CPU the same prefill and segment loop run eagerly;
* a model split over a model group keeps the eager prefill and the
  per-step eager loop (``decode_step`` until ``done``), and so does its
  stream (``core/graphs.capturable`` says why).

``decoding`` picks a call's route and runs its prefill; ``generate_tokens``
decodes to ``max_length`` in it, ``streaming.stream_generate`` chunk by
chunk.

Sampling draws its uniform numbers from the caller's generator outside the
graph, one ``uniform_`` per step into the static draw buffer, exactly as the
eager step draws them; the Gumbel transform runs inside the step.  So a
seed gives the per-step eager loop's draws on the card, and its tokens
wherever the two loops' kernels agree bit for bit (they run the same
kernels at the same shapes).  Injected ``noise(t)`` is copied into the same
buffer before each step.

A model split over a model group (``parallel/mesh.shard_params``) generates
on every model rank at once, with the same inputs: each rank holds its
heads' cache, the logits are gathered over the vocabulary, and every rank
samples from them with the same generator, so all emit the same tokens.
With ``gen.int8_weights`` each rank quantizes its shards (the row-split
kernels' scales taken over the group, ``ops/quantization.py``), and an int8
cache holds its heads' rows and scales: every rank's int8 values are the
slices of the unsplit model's, so the tokens are the unsplit int8 run's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Iterator, NamedTuple

import torch

from parler_tts_tpu_torch.core import graphs
from parler_tts_tpu_torch.core.config import GenerationConfig, ParlerTTSConfig
from parler_tts_tpu_torch.core.device import resolve_device
from parler_tts_tpu_torch.generation import sampling
from parler_tts_tpu_torch.models import codec as codec_mod
from parler_tts_tpu_torch.models.decoder import DecodeLayer, DecodeParams, KVCache, init_cache
from parler_tts_tpu_torch.models.delay_pattern import build_delay_pattern, undelay_pattern
from parler_tts_tpu_torch.models.parler import ParlerTTSModel
from parler_tts_tpu_torch.ops.nn import DenseWeight
from parler_tts_tpu_torch.utils import profiling

#: ``noise(t)`` -> (B, K, V) Gumbel noise for the token sampled at position t
NoiseFn = Callable[[int], torch.Tensor]

#: decode steps per segment (JAX ``models/decoder.STAGE``)
STAGE = 64

# Counters (``utils/profiling.counters()``): ``decode.replays``, steps
# replayed from CUDA graphs; ``decode.positions``, positions the loop kept
# (every route); ``decode.captures`` and ``decode.capture_s``, step graphs
# captured and the seconds spent on them (warm-up step included);
# ``decode.states_dropped``, static states dropped to make room for a new one;
# ``prefill.replays``, ``prefill.captures`` and ``prefill.capture_s``, the
# same for prefill graphs (the warm-up, which is the capturing call's
# prefill, included); ``decode.kv_bytes``, ``decode.conv_state_bytes`` and
# ``decode.ssm_state_bytes``, the cache bytes the kept steps move
# (``KVCache.step_bytes``: self K/V over the bucket and cross K/V, read; the
# LFM2 and Nemotron-H families' conv state, read; Nemotron-H's fp32 SSM
# state, read and written); ``moe.assignments``, ``moe.experts_touched``,
# ``moe.dropped`` (always 0, and checked) and, for a layer holding a share of
# the experts, ``moe.pairs_elsewhere``: a call's routed (token, expert)
# pairs, the held experts given a token summed over MoE calls, pairs
# dropped, and pairs routed to experts held elsewhere, counted on the device
# from the prefill on and read once after the loop (``ops/moe.py``).  Spans:
# ``generate.capture`` and ``generate.prefill`` (both with the state's
# ``kv_bytes``, ``conv_bytes`` and ``ssm_bytes``), ``generate.segment`` and
# ``generate.finalize``.


class GenerateOutput(NamedTuple):
    """tokens: raw delayed ids (B, K, max_length); codes: undelayed codec
    codes (B, K, T_codes); code_lengths: valid frames per sample; audio:
    (B, T_codes * hop) waveform; audio_lengths: valid samples per sample."""

    tokens: torch.Tensor
    codes: torch.Tensor
    code_lengths: torch.Tensor
    audio: torch.Tensor
    audio_lengths: torch.Tensor


@dataclasses.dataclass
class DecodeState:
    """The decode loop between two steps.  ``t`` is the position sampled
    next as the host counts it and ``position`` the same on the device,
    which the steps read and advance; ``logits`` (rows, K, V) predict it.
    ``tokens`` (B, K, max_length) is the delayed buffer, ``pattern`` its
    forced ids (-1 where the model samples).  ``limits`` are the KV-read
    buckets (fused lengths) and ``p_len`` the prompt's length; ``draw`` (B,
    K, V) fp32 holds the next step's uniform draws or injected Gumbel noise
    (None when greedy).  Every tensor is updated in place."""

    t: int
    position: torch.Tensor  # 0-d int64
    tokens: torch.Tensor
    pattern: torch.Tensor
    finished: torch.Tensor  # (B, K) bool: the stream emitted EOS
    cache: KVCache
    logits: torch.Tensor
    fused_mask: torch.Tensor  # (rows, P + max_length)
    enc_mask: torch.Tensor | None  # (rows, S), None without cross-attention
    params: DecodeParams
    use_cfg: bool
    limits: list[int]
    p_len: int
    draw: torch.Tensor | None

    @property
    def done(self) -> bool:
        """Every position written, or every stream finished (a host sync)."""
        return self.t >= self.tokens.shape[2] or bool(self.finished.all())


def _rows(x: torch.Tensor, use_cfg: bool) -> torch.Tensor:
    return torch.cat([x, x], dim=0) if use_cfg else x


def _null_rows(x: torch.Tensor, use_cfg: bool) -> torch.Tensor:
    return torch.cat([x, torch.zeros_like(x)], dim=0) if use_cfg else x


def _kv_read_limits(min_limit: int, t_fused_max: int, max_buckets: int,
                    batch_rows: int | None = None) -> list[int]:
    """The decode loop's KV-read buckets (JAX ``_kv_read_limits``): fused
    lengths, multiples of a step, at most ``max_buckets`` of them, the last
    ``t_fused_max``, the first at least ``min_limit`` so that the prefill
    fits.  The step is at least 256 for at most 4 rows (``batch_rows``) and
    128 otherwise; JAX's trace-time ``PARLER_KV_MIN_STEP`` is not read."""
    if max_buckets <= 1 or t_fused_max <= 256:
        return [t_fused_max]
    floor = 256 if batch_rows is not None and batch_rows <= 4 else 128
    step = max(floor, -(-t_fused_max // max_buckets // 128) * 128)
    limits = [size for size in range(step, t_fused_max, step) if size >= max(min_limit, step)]
    return limits + [t_fused_max]


class _Plan(NamedTuple):
    """What a generation's inputs fix before anything runs."""

    batch: int
    device: torch.device
    rows: int
    use_cfg: bool
    p_len: int
    enc_len: int
    t0: int  # the first decode position: the BOS frame and the audio-prompt frames
    limits: list[int]


def _plan(model: ParlerTTSModel, gen: GenerationConfig, max_length: int, input_ids, prompt_input_ids,
          prompt_hidden_states, decoder_input_codes) -> _Plan:
    """The inputs' batch, CFG rows, prompt and encoder lengths, first
    decode position and KV-read buckets; raises when the fused length
    exceeds the position table."""
    first = next((x for x in (input_ids, prompt_input_ids, prompt_hidden_states, decoder_input_codes)
                  if x is not None), None)
    if first is None:
        raise ValueError("need input_ids, prompt_input_ids, prompt_hidden_states or decoder_input_codes "
                         "for the batch size")
    b = first.shape[0]
    use_cfg = gen.guidance_scale is not None and gen.guidance_scale > 1.0
    rows = 2 * b if use_cfg else b
    prompt = prompt_hidden_states if prompt_hidden_states is not None else prompt_input_ids
    p_len = 0 if prompt is None else prompt.shape[1]
    t0 = 1 + (0 if decoder_input_codes is None else decoder_input_codes.shape[2])
    model.decoder.check_positions(p_len + max_length)
    limits = _kv_read_limits(p_len + t0, p_len + max_length, gen.kv_read_buckets, batch_rows=rows)
    return _Plan(b, first.device, rows, use_cfg, p_len, 0 if input_ids is None else input_ids.shape[1], t0, limits)


def _flush_prompt(prompt_hidden: torch.Tensor, p_mask: torch.Tensor):
    """Each row's valid prompt positions moved, in order, to the end of the
    prompt, its padding to the front: one run of keys against the BOS frame,
    which the prefill's key bounds (``ops/flash_attention.kv_bounds``) take,
    whatever the tokenizer's padding left between them.  Returns the moved
    states and mask and, for each new place, the position it came from
    (``ParlerDecoder`` keeps it as the token's absolute position)."""
    order = torch.argsort((p_mask != 0).to(torch.int32), dim=1, stable=True)
    hidden = torch.gather(prompt_hidden, 1, order[..., None].expand(-1, -1, prompt_hidden.shape[2]))
    return hidden, torch.gather(p_mask, 1, order), order


def _prefill_tensors(model: ParlerTTSModel, gen: GenerationConfig, plan: _Plan, cache: KVCache, *, max_length: int,
                     input_ids, attention_mask, prompt_input_ids, prompt_attention_mask, prompt_hidden_states,
                     decoder_input_codes):
    """The prefill's device work: writes the cache and returns (tokens,
    pattern, first logits, fused mask, encoder mask or None).  It reads
    nothing on the host and copies nothing from it, so a CUDA graph can
    capture it."""
    decoder = model.decoder
    b, device, rows, use_cfg = plan.batch, plan.device, plan.rows, plan.use_cfg

    enc_hidden = enc_mask = None
    if input_ids is not None:
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids, dtype=torch.int32)
        enc_hidden = _null_rows(model.encode_text(input_ids, attention_mask), use_cfg)
        enc_mask = _null_rows(attention_mask, use_cfg)

    if prompt_hidden_states is not None:
        prompt_hidden = prompt_hidden_states.to(decoder.dtype)
    elif prompt_input_ids is not None:
        prompt_hidden = model.embed_prompts(prompt_input_ids)
    else:
        prompt_hidden = None
    prompt_positions = None
    if prompt_hidden is None:
        p_mask = torch.zeros((rows, 0), dtype=torch.int32, device=device)
    else:
        p_mask = prompt_attention_mask
        if p_mask is None:
            p_mask = torch.ones(prompt_hidden.shape[:2], dtype=torch.int32, device=device)
        # guidance on the description repeats the prompt rows; without text
        # it is guidance on the prompt itself, against zeroed prompt rows
        repeat = _rows if input_ids is not None else _null_rows
        prompt_hidden, p_mask = repeat(prompt_hidden, use_cfg), repeat(p_mask, use_cfg)
        prompt_hidden, p_mask, prompt_positions = _flush_prompt(prompt_hidden, p_mask)

    start_ids = torch.full((b, decoder.cfg.num_codebooks, 1), gen.decoder_start_token_id, dtype=torch.int32,
                           device=device)
    if decoder_input_codes is not None:
        start_ids = torch.cat([start_ids, decoder_input_codes.to(torch.int32)], dim=2)
    _, pattern, t0 = build_delay_pattern(
        start_ids, bos_token_id=gen.bos_token_id, pad_token_id=gen.pad_token_id, max_length=max_length
    )
    tokens = torch.where(pattern == -1, gen.pad_token_id, pattern).to(torch.int32)

    cache.index = 0
    fused_mask = torch.cat(
        [p_mask.to(torch.int32), torch.ones((rows, max_length), dtype=torch.int32, device=device)], dim=1
    )
    hidden = decoder(
        _rows(tokens[:, :, :t0], use_cfg),
        encoder_hidden_states=enc_hidden,
        encoder_attention_mask=enc_mask,
        prompt_hidden_states=prompt_hidden,
        prompt_positions=prompt_positions,
        attention_mask=fused_mask,
        cache=cache,
    )
    logits = decoder.logits(hidden, num_labels=1)[:, :, 0]
    return tokens, pattern, logits, fused_mask, enc_mask


@torch.no_grad()
def prefill(model: ParlerTTSModel, gen: GenerationConfig, *, max_length: int,
            input_ids: torch.Tensor | None = None, attention_mask: torch.Tensor | None = None,
            prompt_input_ids: torch.Tensor | None = None, prompt_attention_mask: torch.Tensor | None = None,
            prompt_hidden_states: torch.Tensor | None = None,
            decoder_input_codes: torch.Tensor | None = None, cache: KVCache | None = None,
            params: DecodeParams | None = None) -> DecodeState:
    """Text encode, prompt embed, CFG rows, delay pattern and the decoder
    prefill over ``[prompt | BOS frame | audio-prompt codes]``, eagerly.
    Inputs are tensors on the model's device; the batch size comes from the
    first of ``input_ids``, ``prompt_input_ids``, ``prompt_hidden_states``
    and ``decoder_input_codes`` given.  Raises when the fused length exceeds
    ``max_position_embeddings``.  ``cache``: an allocated cache of this
    generation's shapes to write (its contents are overwritten), else a new
    one.  ``params``: the decode view the steps run, else one built here
    (``decoder.decode_params`` copies every decode weight)."""
    decoder = model.decoder
    plan = _plan(model, gen, max_length, input_ids, prompt_input_ids, prompt_hidden_states, decoder_input_codes)
    with profiling.span("generate.prefill", plan.device, route="eager") as sp:
        if cache is None:
            cache = init_cache(decoder.cfg, plan.rows, plan.p_len + max_length, plan.enc_len, dtype=decoder.dtype,
                               device=plan.device, kv_dtype=gen.kv_cache_dtype, heads=decoder.num_heads)
        sp.set(**_state_bytes(cache))
        tokens, pattern, logits, fused_mask, enc_mask = _prefill_tensors(
            model, gen, plan, cache, max_length=max_length, input_ids=input_ids, attention_mask=attention_mask,
            prompt_input_ids=prompt_input_ids, prompt_attention_mask=prompt_attention_mask,
            prompt_hidden_states=prompt_hidden_states, decoder_input_codes=decoder_input_codes)
    return DecodeState(
        t=plan.t0, position=torch.tensor(plan.t0, device=plan.device), tokens=tokens, pattern=pattern,
        finished=torch.zeros((plan.batch, decoder.cfg.num_codebooks), dtype=torch.bool, device=plan.device),
        cache=cache, logits=logits, fused_mask=fused_mask, enc_mask=enc_mask,
        params=decoder.decode_params(gen.int8_weights) if params is None else params, use_cfg=plan.use_cfg,
        limits=plan.limits, p_len=plan.p_len,
        draw=torch.empty((plan.batch, *logits.shape[1:]), dtype=torch.float32, device=plan.device)
        if gen.do_sample else None,
    )


def _advance(model: ParlerTTSModel, gen: GenerationConfig, s: DecodeState, *, t_hi: int, read_len: int,
             injected: bool) -> None:
    """One masked step, in place: sample position ``s.position`` from
    ``s.logits`` (with ``s.draw``: Gumbel noise when ``injected``, else
    uniform draws), write it, run one cached decoder step on it over the
    cache's first ``read_len`` positions, and keep the new position, token,
    ``finished`` and logits only where ``position < t_hi`` and some stream
    is unfinished (JAX ``make_segment_body``).  Reads nothing on the host:
    the segment loop replays it from a CUDA graph.  Positions are clamped
    to the token buffer, so a step at ``t = max_length`` (a warm-up or
    capture run over stale buffers) writes inside it."""
    b, max_length = s.tokens.shape[0], s.tokens.shape[2]
    t = s.position
    keep = (t < t_hi) & ~s.finished.all()
    logits = s.logits
    if s.use_cfg:
        logits = sampling.apply_cfg(logits[:b], logits[b:], gen.guidance_scale)
    logits = sampling.process_logits(logits, gen)
    noise = None
    if gen.do_sample:
        noise = s.draw if injected else sampling.gumbel_of(s.draw)
    sampled = sampling.select_tokens(logits, gen, noise=noise).to(torch.int32)
    sampled = sampled.masked_fill(s.finished, gen.pad_token_id)
    finished = s.finished | (sampled == gen.eos_token_id)
    col = t.clamp(max=max_length - 1).view(1)
    forced = s.tokens.index_select(2, col)
    token_t = torch.where(s.pattern.index_select(2, col) == -1, sampled[:, :, None], forced)
    decoder = model.decoder
    hidden = decoder.step(_rows(token_t, s.use_cfg), s.cache, col + s.p_len, read_len, params=s.params,
                          attention_mask=s.fused_mask, encoder_attention_mask=s.enc_mask)
    new_logits = decoder.logits(hidden, num_labels=1, heads=s.params.lm_heads)[:, :, 0]
    s.tokens.index_copy_(2, col, torch.where(keep, token_t, forced))
    s.finished.copy_(torch.where(keep, finished, s.finished))
    s.logits.copy_(torch.where(keep, new_logits, s.logits))
    s.position.copy_(t + keep.to(t.dtype))


def _draw(gen: GenerationConfig, s: DecodeState, generator: torch.Generator | None, noise: NoiseFn | None,
          t: int) -> None:
    """Fill ``s.draw`` for the step at position ``t``: ``noise(t)``, or one
    ``uniform_`` from ``generator`` (``torch.rand``'s draws)."""
    if not gen.do_sample:
        return
    if noise is not None:
        s.draw.copy_(noise(t))
    elif generator is None:
        raise ValueError("sampling needs a torch.Generator or injected noise")
    else:
        s.draw.uniform_(generator=generator)


def _state_bytes(cache: KVCache) -> dict[str, int]:
    """A span's record of the state a cache holds, by kind."""
    return {f"{kind}_bytes": n for kind, n in cache.nbytes_by_kind().items()}


def _read_len(s: DecodeState) -> int:
    """The KV-read bucket of the step at ``s.t``."""
    return next(size for size in s.limits if size > s.p_len + s.t)


@torch.no_grad()
def decode_step(model: ParlerTTSModel, gen: GenerationConfig, s: DecodeState, *,
                generator: torch.Generator | None = None, noise: NoiseFn | None = None) -> None:
    """Sample position ``s.t`` from ``s.logits``, write it, run one cached
    decoder step on it and advance ``s`` in place: the segment loop's step,
    eager, over its KV-read bucket, so both loops read the same lengths.
    Call it while ``not s.done``.  A split model's loop runs on this
    function."""
    _draw(gen, s, generator, noise, s.t)
    read_len = _read_len(s)
    _advance(model, gen, s, t_hi=s.tokens.shape[2], read_len=read_len, injected=noise is not None)
    s.t += 1
    _count_steps(s, read_len, 1)


def _count_steps(s: DecodeState, read_len: int, kept: int) -> None:
    profiling.count("decode.positions", kept)
    read = s.cache.step_bytes(read_len)
    profiling.count("decode.kv_bytes", kept * read["kv"])
    profiling.count("decode.conv_state_bytes", kept * read["conv"])
    profiling.count("decode.ssm_state_bytes", kept * read["ssm"])


#: runs ``n`` steps of one bucket: (bucket's fused length, its t_hi, n)
Segment = Callable[[int, int, int], None]


def _decode(s: DecodeState, end: int, segment: Segment) -> int:
    """The loop nest over the buckets and their segments, from ``s.t`` up to
    position ``end`` or until every stream has finished (JAX ``run_chunk``'s
    ``(t < end) & ~all(finished)``): ``generate_tokens`` runs it once with
    ``end = max_length``, a stream once per chunk, and a chunk that crosses
    a bucket's end goes on in the next bucket.  Returns the position the
    loop stopped at (JAX ``generate_tokens``' ``final.t``).  The host reads
    ``all(finished)`` once per segment, inside the segment's span, whose
    units are the positions the segment kept."""
    for size in s.limits:
        t_hi = min(s.tokens.shape[2], size - s.p_len)
        while s.t < min(t_hi, end):
            n = min(STAGE, t_hi - s.t, end - s.t)
            with profiling.span("generate.segment", s.tokens.device, bucket=size, steps=n) as sp:
                segment(size, t_hi, n)
                finished = bool(s.finished.all())
                kept = int(s.position) - s.t if finished else n
                sp.set(units=kept)
            _count_steps(s, size, kept)
            s.t += kept
            if finished:
                return s.t
    return s.t


def _eager_segment(model, gen, s: DecodeState, generator, noise) -> Segment:
    def run(size: int, t_hi: int, n: int) -> None:
        for i in range(n):
            _draw(gen, s, generator, noise, s.t + i)
            _advance(model, gen, s, t_hi=t_hi, read_len=size, injected=noise is not None)
    return run


class _Prefill(NamedTuple):
    """One input shape's captured prefill: its static inputs and its program
    (on a pool of its own)."""

    inputs: dict[str, torch.Tensor | None]
    program: graphs.Program


class _Captured:
    """One signature's static decode state and its captured programs: a step
    program per KV-read bucket (keyed by the bucket's fused length) sharing
    one memory pool, and a prefill per input shape (``_Prefill``).
    ``nbytes`` counts the state, the static inputs and the pools."""

    def __init__(self, state: DecodeState):
        self.state = state
        self.steps: dict[int, graphs.Program] = {}
        self.prefills: dict[tuple, _Prefill] = {}
        self.pool = graphs.new_pool()
        self.nbytes = state.cache.nbytes + _nbytes(state.position, state.tokens, state.pattern, state.finished,
                                                   state.logits, state.fused_mask, state.enc_mask, state.draw)


def _nbytes(*tensors: torch.Tensor | None) -> int:
    return sum(x.numel() * x.element_size() for x in tensors if x is not None)


class _Views(dict):
    """The decode views by ``int8_weights`` and dtype, shared by every
    signature and refreshed from the weights at each call; a copied model
    builds its own."""

    def __deepcopy__(self, memo) -> "_Views":
        return _Views()


def _programs_of(model: ParlerTTSModel) -> graphs.Programs:
    """The model's static decode states (``_Captured``) by signature, kept
    on it so that they die with it."""
    return model.__dict__.setdefault("_decode_programs", graphs.Programs())


def _clone_view(p: DecodeParams) -> DecodeParams:
    def clone(w: DenseWeight) -> DenseWeight:
        return DenseWeight(w.kernel.clone(), None if w.scale is None else w.scale.clone())

    return DecodeParams([DecodeLayer(*map(clone, layer)) for layer in p.layers], clone(p.lm_heads))


def _view_tensors(p: DecodeParams) -> list[torch.Tensor]:
    weights = [w for layer in p.layers for w in layer] + [p.lm_heads]
    return [x for w in weights for x in (w.kernel, w.scale) if x is not None]


def _capture(captured: _Captured, fn: Callable[[], None], pool, counters: str, **attrs) -> graphs.Program:
    """``fn`` captured on ``pool`` (None: its own) in a ``generate.capture``
    span with ``attrs``, counted in ``{counters}.captures`` and
    ``{counters}.capture_s``; its pool's bytes count in ``captured``."""
    s = captured.state
    with profiling.span("generate.capture", s.tokens.device, **attrs, **_state_bytes(s.cache)) as sp:
        program = graphs.capture(fn, pool)
        sp.set(seconds=program.seconds, nbytes=program.nbytes)
    captured.nbytes += program.nbytes
    profiling.count(f"{counters}.captures")
    profiling.count(f"{counters}.capture_s", program.seconds)
    return program


def _prefill_into(model, gen, plan: _Plan, s: DecodeState, max_length: int, inputs: dict) -> None:
    """The prefill of ``inputs`` written into the static state: the
    function a prefill graph holds."""
    tokens, pattern, logits, fused_mask, enc_mask = _prefill_tensors(model, gen, plan, s.cache,
                                                                      max_length=max_length, **inputs)
    s.position.fill_(plan.t0)
    s.tokens.copy_(tokens)
    s.pattern.copy_(pattern)
    s.finished.zero_()
    s.logits.copy_(logits)
    s.fused_mask.copy_(fused_mask)
    if s.enc_mask is not None:
        s.enc_mask.copy_(enc_mask)


def _input_shapes(inputs: dict) -> tuple:
    return tuple((name, None if x is None else (tuple(x.shape), x.dtype)) for name, x in sorted(inputs.items()))


def _captured_prefill(model, gen, captured: _Captured, plan: _Plan, *, max_length: int, **inputs) -> None:
    """The prefill of ``inputs`` into the signature's static state, by the
    program of their shapes (the JAX stream's and pipeline's jitted
    prefill).  At the first call of a shape the warm-up, on the call's own
    inputs copied into new static buffers, is the call's prefill, and the
    graph is captured after it (a replay would run it twice); later calls
    copy their inputs into those buffers and replay.  The host then sets
    what a replay cannot: ``t``, the buckets and the cache's index."""
    s = captured.state
    shapes = _input_shapes(inputs)
    known = captured.prefills.get(shapes)
    device = s.tokens.device
    with profiling.span("generate.prefill", device, route="captured" if known is None else "replayed",
                        **_state_bytes(s.cache)):
        if known is None:
            static = {name: None if x is None else x.to(device, copy=True) for name, x in inputs.items()}
            program = _capture(captured, lambda: _prefill_into(model, gen, plan, s, max_length, static), None,
                               "prefill", kind="prefill", rows=plan.rows, prompt_len=plan.p_len,
                               encoder_len=plan.enc_len, max_length=max_length,
                               shapes={name: list(x.shape) for name, x in inputs.items() if x is not None})
            captured.prefills[shapes] = _Prefill(static, program)
            captured.nbytes += _nbytes(*static.values())
        else:
            for name, x in inputs.items():
                if x is not None:
                    known.inputs[name].copy_(x)
            known.program.replay()
            profiling.count("prefill.replays")
    s.t, s.limits = plan.t0, plan.limits
    s.cache.index = plan.p_len + plan.t0


def _captured_generation(model: ParlerTTSModel, gen: GenerationConfig, programs: graphs.Programs, *,
                         max_length: int, generator, noise, **inputs) -> tuple[tuple, _Captured, Segment]:
    """A static state of this call's signature that no call leases
    (allocated, and its buckets' steps captured, on first use), filled by
    the captured prefill: its key in ``programs``, the state, and the
    segment that replays its step programs.  The caller holds
    ``programs.lock``."""
    decoder = model.decoder
    plan = _plan(model, gen, max_length, inputs["input_ids"], inputs["prompt_input_ids"],
                 inputs["prompt_hidden_states"], inputs["decoder_input_codes"])
    device = next(decoder.parameters()).device
    signature = (plan.rows, plan.p_len, plan.enc_len, max_length, decoder.dtype, gen, noise is not None,
                 tuple(p.data_ptr() for p in decoder.parameters()), tuple(b.data_ptr() for b in decoder.buffers()))
    # the decode view, refreshed from the weights at every call: a copy of
    # its own, never the parameters a plain view shares
    fresh = decoder.decode_params(gen.int8_weights)
    views = model.__dict__.setdefault("_decode_views", _Views())
    view = views.get((gen.int8_weights, decoder.dtype))
    if view is None:
        view = views[(gen.int8_weights, decoder.dtype)] = _clone_view(fresh)
    for dst, src in zip(_view_tensors(view), _view_tensors(fresh)):
        dst.copy_(src)
    del fresh

    def make() -> _Captured:
        k, v = decoder.cfg.num_codebooks, decoder.cfg.vocab_size

        def cache_on(where):
            return init_cache(decoder.cfg, plan.rows, plan.p_len + max_length, plan.enc_len, dtype=decoder.dtype,
                              device=where, kv_dtype=gen.kv_cache_dtype, heads=decoder.num_heads)

        # before the new cache is allocated
        dropped = programs.make_room(cache_on(torch.device("meta")).nbytes, graphs.budget(device))
        if dropped:
            profiling.count("decode.states_dropped", dropped)

        def zeros(*shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        return _Captured(DecodeState(
            t=0, position=zeros(dtype=torch.int64), tokens=zeros(plan.batch, k, max_length, dtype=torch.int32),
            pattern=zeros(plan.batch, k, max_length, dtype=torch.int32),
            finished=zeros(plan.batch, k, dtype=torch.bool), cache=cache_on(device),
            logits=zeros(plan.rows, k, v, dtype=decoder.dtype),
            fused_mask=zeros(plan.rows, plan.p_len + max_length, dtype=torch.int32),
            enc_mask=zeros(plan.rows, plan.enc_len, dtype=torch.int64) if plan.enc_len else None,
            params=view, use_cfg=plan.use_cfg, limits=[], p_len=plan.p_len,
            draw=zeros(plan.batch, k, v, dtype=torch.float32) if gen.do_sample else None))

    key, captured = programs.instance(signature, make)
    s = captured.state
    for size in plan.limits:  # each step's warm-up and capture run before the prefill overwrites what they wrote
        if size not in captured.steps:
            step = functools.partial(_advance, model, gen, s, t_hi=min(max_length, size - plan.p_len), read_len=size,
                                     injected=noise is not None)
            captured.steps[size] = _capture(captured, step, captured.pool, "decode", kind="step", rows=plan.rows,
                                            prompt_len=plan.p_len, encoder_len=plan.enc_len, max_length=max_length,
                                            bucket=size)
    _captured_prefill(model, gen, captured, plan, max_length=max_length, **inputs)

    def replay(size: int, t_hi: int, n: int) -> None:
        program = captured.steps[size]
        graph = program.graph
        for i in range(n):
            _draw(gen, s, generator, noise, s.t + i)
            graph.replay()
        program.replayed(n)
        profiling.count("decode.replays", n)

    return key, captured, replay


@contextlib.contextmanager
def decoding(model: ParlerTTSModel, gen: GenerationConfig, *, max_length: int, generator: torch.Generator | None,
             noise: NoiseFn | None, **inputs) -> Iterator[tuple[DecodeState, Callable[[int], None]]]:
    """One call's route, prefill and decode loop (``inputs`` as
    ``generate_tokens``'): yields the state after the prefill and
    ``decode_to(end)``, which runs the loop from ``s.t`` up to position
    ``end`` or until every stream has finished.  The route is the module
    docstring's: the captured programs where ``core/graphs.capturable``,
    else the per-step loop on a split model, else the eager segments.  On
    the captured route the call leases its signature's static state until
    the block ends, so no other call takes it, and holds the model's graph
    lock for the prefill and within each ``decode_to``, never between."""
    decoder = model.decoder
    if graphs.capturable(next(decoder.parameters()).device, [decoder.model_group]):
        programs = _programs_of(model)
        with programs.lock:
            key, captured, segment = _captured_generation(model, gen, programs, max_length=max_length,
                                                          generator=generator, noise=noise, **inputs)
            programs.leased.add(key)
        try:
            def decode_to(end: int) -> None:
                with programs.lock:
                    _decode(captured.state, end, segment)

            yield captured.state, decode_to
        finally:
            # no lock: a stream dropped unfinished is closed wherever the
            # collector runs, perhaps on a thread inside ``programs.lock``
            programs.leased.discard(key)
        return
    s = prefill(model, gen, max_length=max_length, **inputs)
    if decoder.model_group is not None:
        def decode_to(end: int) -> None:
            while s.t < end and not s.done:
                decode_step(model, gen, s, generator=generator, noise=noise)
    else:
        segment = _eager_segment(model, gen, s, generator, noise)

        def decode_to(end: int) -> None:
            _decode(s, end, segment)
    yield s, decode_to


@torch.no_grad()
def generate_tokens(model: ParlerTTSModel, gen: GenerationConfig, *, max_length: int,
                    input_ids: torch.Tensor | None = None, attention_mask: torch.Tensor | None = None,
                    prompt_input_ids: torch.Tensor | None = None,
                    prompt_attention_mask: torch.Tensor | None = None,
                    prompt_hidden_states: torch.Tensor | None = None,
                    decoder_input_codes: torch.Tensor | None = None,
                    generator: torch.Generator | None = None,
                    noise: NoiseFn | None = None) -> tuple[torch.Tensor, int]:
    """Prefill + decode loop on the model's device.  ``input_ids`` None
    turns text conditioning off (no T5 encode, no cross-attention) and
    ``prompt_input_ids`` None drops the prompt prefix, unless
    ``prompt_hidden_states`` (B, P, H) supplies it embedded.  Returns
    (delayed tokens (B, K, max_length) int32, the position the loop stopped
    at).  The loop is the module docstring's: CUDA graphs on a CUDA model
    without a model group, the same steps eagerly on the CPU, the per-step
    loop on a split model."""
    with decoding(model, gen, max_length=max_length, generator=generator, noise=noise, input_ids=input_ids,
                  attention_mask=attention_mask, prompt_input_ids=prompt_input_ids,
                  prompt_attention_mask=prompt_attention_mask, prompt_hidden_states=prompt_hidden_states,
                  decoder_input_codes=decoder_input_codes) as (s, decode_to):
        decode_to(max_length)
        tokens, t = s.tokens.clone(), s.t
    _count_experts(model.decoder)
    return tokens, t


def _count_experts(decoder) -> None:
    """The call's MoE counts, read from the device once (models with
    experts only); a dropped pair raises."""
    stats = getattr(decoder, "moe_stats", None)
    if stats is None:
        return
    assignments, touched, dropped, *elsewhere = stats.tolist()
    profiling.count("moe.assignments", assignments)
    profiling.count("moe.experts_touched", touched)
    profiling.count("moe.dropped", dropped)
    if elsewhere:
        profiling.count("moe.pairs_elsewhere", elsewhere[0])
    if dropped:
        raise RuntimeError(f"the experts dropped {dropped} routed (token, expert) pairs")


def postprocess_tokens(tokens: torch.Tensor, cfg: ParlerTTSConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Drop the BOS column, undelay, and cut each sample at its first frame
    holding a special id (>= codebook_size) in any codebook.  Returns (codes
    (B, K, T') zeroed past the cut, code_lengths (B,) int32)."""
    codes = undelay_pattern(tokens[:, :, 1:])
    t = codes.shape[-1]
    special = (codes >= cfg.audio_encoder.codebook_size).any(dim=1)  # (B, T')
    if t == 0:
        first_special = torch.zeros(codes.shape[0], dtype=torch.int64, device=codes.device)
    else:
        first_special = torch.where(special.any(dim=1), special.int().argmax(dim=1), t)
    valid = torch.arange(t, device=codes.device)[None] < first_special[:, None]
    codes = torch.where(valid[:, None, :], codes, 0)
    return codes, first_special.to(torch.int32)


def check_vocodable(cfg: ParlerTTSConfig) -> None:
    """Raise unless the codec takes the decoder's codebook streams (a stereo
    decoder emits twice the codec's: there is no stereo vocode)."""
    if cfg.decoder.num_codebooks != cfg.audio_encoder.num_codebooks:
        raise ValueError(
            f"decoder emits {cfg.decoder.num_codebooks} codebook streams but the codec "
            f"takes {cfg.audio_encoder.num_codebooks} (audio_channels="
            f"{cfg.decoder.audio_channels}); there is no stereo vocode, use vocode=False"
        )


def _finalize(model: ParlerTTSModel, tokens: torch.Tensor, *, vocode: bool = True) -> GenerateOutput:
    """Undelay/trim, then one batched codec vocode of the trimmed codes."""
    cfg = model.cfg
    with profiling.span("generate.finalize", tokens.device):
        codes, code_lengths = postprocess_tokens(tokens, cfg)
    if vocode:
        check_vocodable(cfg)
        audio = codec_mod.decode(model.audio_encoder, codes)
    else:
        audio = torch.zeros((tokens.shape[0], 0), dtype=torch.float32, device=tokens.device)
    audio_lengths = code_lengths * cfg.audio_encoder.hop_length
    return GenerateOutput(tokens, codes, code_lengths, audio, audio_lengths)


def to_device(device: torch.device, x) -> torch.Tensor | None:
    """``x`` (numpy, tensor or None) as a tensor on ``device``."""
    return None if x is None else torch.as_tensor(x, device=device)


def model_device(model: ParlerTTSModel, device: str | torch.device) -> torch.device:
    """The model's device, which must be the ``device`` asked for."""
    device = resolve_device(device)
    param_device = next(model.parameters()).device
    if param_device.type != device.type or device.index not in (None, param_device.index):
        raise ValueError(f"model is on {param_device}, generation was asked to run on {device}")
    return param_device


def audio_prompt_codes(model: ParlerTTSModel, input_values: torch.Tensor | None,
                       decoder_input_codes: torch.Tensor | None, *,
                       stereo_repeat: bool = True) -> torch.Tensor | None:
    """The audio prompt as codes (B, K, frames): ``input_values`` (B, T)
    encoded by the model's codec, or ``decoder_input_codes`` as given.  With
    ``stereo_repeat``, mono codes into a stereo decoder are repeated per
    channel (JAX ``generate`` ``:423-429``)."""
    if input_values is not None:
        if decoder_input_codes is not None:
            raise ValueError("pass input_values or decoder_input_codes, not both")
        decoder_input_codes = codec_mod.encode(model.audio_encoder, input_values)
    dcfg = model.cfg.decoder
    if (stereo_repeat and decoder_input_codes is not None and dcfg.audio_channels == 2
            and decoder_input_codes.shape[1] == dcfg.num_codebooks // 2):
        decoder_input_codes = decoder_input_codes.repeat_interleave(2, dim=1)
    return decoder_input_codes


@torch.no_grad()
def generate(model: ParlerTTSModel, gen: GenerationConfig, *, input_ids, prompt_input_ids,
             attention_mask=None, prompt_attention_mask=None, input_values=None, decoder_input_codes=None,
             max_length: int | None = None, generator: torch.Generator | None = None,
             noise: NoiseFn | None = None, vocode: bool = True,
             device: str | torch.device = "cuda") -> GenerateOutput:
    """description ids (B, S) + prompt ids (B, P) -> waveform.

    ``input_values`` (B, T) raw audio continues a voice (encoded by the
    model's codec); ``decoder_input_codes`` (B, K, frames) passes its codes
    instead.  Inputs may be numpy arrays or tensors; they are moved to
    ``device``, where the model must already live.  Sampling
    (``gen.do_sample``) draws its Gumbel noise from ``generator``, or takes
    it from ``noise(t)``."""
    dev = model_device(model, device)
    codes = audio_prompt_codes(model, to_device(dev, input_values), to_device(dev, decoder_input_codes))
    input_ids = to_device(dev, input_ids)
    prompt_input_ids = to_device(dev, prompt_input_ids)
    tokens, _ = generate_tokens(
        model, gen, max_length=max_length or gen.max_length,
        input_ids=input_ids, attention_mask=to_device(dev, attention_mask),
        prompt_input_ids=prompt_input_ids, prompt_attention_mask=to_device(dev, prompt_attention_mask),
        decoder_input_codes=codes, generator=generator, noise=noise,
    )
    return _finalize(model, tokens, vocode=vocode)


@torch.no_grad()
def generate_decoder_only(model: ParlerTTSModel, gen: GenerationConfig, *, decoder_input_codes=None,
                          input_values=None, prompt_hidden_states=None, prompt_attention_mask=None,
                          batch_size: int | None = None, max_length: int | None = None,
                          generator: torch.Generator | None = None, noise: NoiseFn | None = None,
                          vocode: bool = True, device: str | torch.device = "cuda") -> GenerateOutput:
    """Audio continuation with no text conditioning: no T5 encode and no
    cross-attention in any layer (JAX ``generate_decoder_only``).

    Continue ``input_values`` (B, T) raw audio or ``decoder_input_codes``
    (B, K, frames); with neither, the model runs free from BOS for
    ``batch_size`` rows (or as many as ``prompt_hidden_states`` has).
    ``prompt_hidden_states`` (B, P, H) prepends embedded prompt states.
    With ``gen.guidance_scale > 1`` the null rows get zeroed prompt rows."""
    dev = model_device(model, device)
    codes = audio_prompt_codes(model, to_device(dev, input_values), to_device(dev, decoder_input_codes),
                               stereo_repeat=False)
    prompt_hidden_states = to_device(dev, prompt_hidden_states)
    if codes is None:
        if batch_size is None and prompt_hidden_states is not None:
            batch_size = prompt_hidden_states.shape[0]
        if batch_size is None:
            raise ValueError("pass decoder_input_codes, input_values or batch_size")
        codes = torch.zeros((batch_size, model.cfg.decoder.num_codebooks, 0), dtype=torch.int32, device=dev)
    tokens, _ = generate_tokens(
        model, gen, max_length=max_length or gen.max_length, decoder_input_codes=codes,
        prompt_hidden_states=prompt_hidden_states,
        prompt_attention_mask=to_device(dev, prompt_attention_mask),
        generator=generator, noise=noise,
    )
    return _finalize(model, tokens, vocode=vocode)
