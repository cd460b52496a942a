"""The port's training path against the JAX package at fp32 on CPU: labels
and batching (exact), ``train_forward``'s loss and logits, the trainable
gradients (through ``to_jax_tree``), one full train step, the schedules and
the optimizer (on identical gradients), and the train-mode semantics of
dropout, layerdrop and remat (mirroring tests/test_dropout.py).

The JAX side runs its XLA attention on CPU (the flash kernels' equality with
it is tests/test_pallas_kernels.py's), the port its plain kernel versions."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from parler_tts_tpu.core import config as jcfg
from parler_tts_tpu.models import decoder as jdecoder
from parler_tts_tpu.models import delay_pattern as jdp
from parler_tts_tpu.models import parler as jparler
from parler_tts_tpu.training import data as jdata
from parler_tts_tpu.training import optim as joptim
from parler_tts_tpu.training import run_training as jrun
from parler_tts_tpu.training import step as jstep
from parler_tts_tpu_torch.core import config as pcfg
from parler_tts_tpu_torch.core.from_jax import load_jax_params, to_jax_tree
from parler_tts_tpu_torch.models import decoder as pdecoder
from parler_tts_tpu_torch.models import delay_pattern as pdp
from parler_tts_tpu_torch.models import parler as pparler
from parler_tts_tpu_torch.ops import nn as pnn
from parler_tts_tpu_torch.training import data as pdata
from parler_tts_tpu_torch.training import optim as poptim
from parler_tts_tpu_torch.training import run_training as prun
from parler_tts_tpu_torch.training import step as pstep
from tests.test_torch_blocks import T, jax_params, port_model, tiny_config

torch.set_num_threads(1)  # tier-1 runs several pytest workers

LOSS_TOL, LOGITS_TOL = 1e-5, 1e-4
GRAD_TOL = 1e-5  # fp32, sums in another order than XLA's (largest grads ~1e-1)


def _batch(cfg, seed=0):
    """Two samples: ragged labels (12 and 8 frames), a right-padded
    description and a left-padded prompt."""
    dcfg = cfg.decoder
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, cfg.audio_encoder.codebook_size, (2, dcfg.num_codebooks, 12))
    labels = np.asarray(jdp.build_delay_pattern_labels(
        codes, np.array([12, 8]), bos_token_id=dcfg.bos_token_id, eos_token_id=dcfg.eos_token_id,
        max_length=12 + dcfg.num_codebooks + 2))
    mask = np.ones((2, 7), np.int32)
    mask[1, 5:] = 0
    p_mask = np.ones((2, 6), np.int32)
    p_mask[0, :3] = 0
    return dict(input_ids=rng.integers(0, cfg.text_encoder.vocab_size, (2, 7)).astype(np.int32),
                attention_mask=mask,
                prompt_input_ids=rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32),
                prompt_attention_mask=p_mask, labels=labels)


@pytest.fixture(scope="module")
def setup():
    jc, pc = tiny_config(jcfg), tiny_config(pcfg)
    params = jax_params(jc)
    return jc, pc, params, _batch(jc)


def _port(params):
    model = port_model(params)
    pparler.set_trainable(model)
    return model


def _tree_close(ref, got, atol, path=""):
    assert set(ref) == set(got), path
    for key in ref:
        if isinstance(ref[key], dict):
            _tree_close(ref[key], got[key], atol, f"{path}/{key}")
        else:
            np.testing.assert_allclose(got[key], np.asarray(ref[key]), atol=atol, rtol=0, err_msg=f"{path}/{key}")


# --- labels and batching ------------------------------------------------------


@pytest.mark.parametrize("k,t_codes,lengths,max_length", [
    (4, 12, [12, 8], 18), (9, 20, [20, 15, 3], 32), (4, 10, [10, 10], 12), (4, 6, [6, 2], 20)])
def test_delay_pattern_labels_exact(k, t_codes, lengths, max_length):
    """Includes a max_length that cuts the EOS tail of the longest sample."""
    codes = np.random.default_rng(k + t_codes).integers(0, 30, (len(lengths), k, t_codes)).astype(np.int32)
    ref = jdp.build_delay_pattern_labels(codes, np.array(lengths), bos_token_id=33, eos_token_id=32,
                                         max_length=max_length)
    got = pdp.build_delay_pattern_labels(T(codes), T(np.array(lengths)), bos_token_id=33, eos_token_id=32,
                                         max_length=max_length)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        pdp.labels_to_decoder_inputs(got, bos_token_id=33, pad_token_id=32).numpy(),
        np.asarray(jdp.labels_to_decoder_inputs(ref, bos_token_id=33, pad_token_id=32)))


def test_synthetic_samples_and_build_labels_exact(setup):
    jc, pc, _, _ = setup
    ref, got = jrun.prepare_synthetic(6, jc, seed=3), prun.prepare_synthetic(6, pc, seed=3)
    for r, g in zip(ref, got):
        assert set(r) == set(g)
        for key in r:
            np.testing.assert_array_equal(np.asarray(g[key]), np.asarray(r[key]))
    codes = [np.random.default_rng(i).integers(0, 32, (4, n)).astype(np.int16) for i, n in enumerate((5, 9))]
    for r, g in zip(jdata.build_labels(codes, bos_token_id=33, eos_token_id=32, max_length=16),
                    pdata.build_labels(codes, bos_token_id=33, eos_token_id=32, max_length=16)):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("kw", [dict(), dict(shuffle=False, drop_last=False), dict(group_by_length=True),
                                dict(seed=5, row_slice=(1, 3))])
def test_collator_and_batches_exact(setup, kw):
    """Left-padded prompts, right-padded descriptions, -100 label padding,
    and the epoch order, against the JAX data pipeline."""
    jc, pc, _, _ = setup
    samples = jrun.prepare_synthetic(11, jc, seed=1)
    args = dict(description_pad_id=0, prompt_pad_id=7, max_description_len=20, max_prompt_len=12,
                label_len=max(s["labels"].shape[1] for s in samples))
    ref = list(jdata.batches(samples, jdata.Collator(**args), 4, **kw))
    got = list(pdata.batches(samples, pdata.Collator(**args), 4, **kw))
    assert len(ref) == len(got) > 0
    for r, g in zip(ref, got):
        assert set(r) == set(g)
        for key in r:
            assert g[key].dtype == r[key].dtype
            np.testing.assert_array_equal(g[key], r[key])


# --- forward, loss and gradients -----------------------------------------------


def test_train_forward_matches_jax(setup):
    jc, _, params, batch = setup
    ref_loss, ref_logits = jparler.train_forward(params, jc, **batch)
    loss, logits = _port(params).train_forward(**{k: T(v) for k, v in batch.items()})
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=LOSS_TOL, rtol=0)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref_logits), atol=LOGITS_TOL, rtol=0)


def test_loss_fn_matches_jax():
    """BOS labels ignored, EOS inputs excluded, per-codebook means."""
    cfg = tiny_config(jcfg).decoder
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((2, 4, 9, cfg.vocab_size)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (2, 4, 9)).astype(np.int32)
    labels[0, :, 6:] = -100
    labels[1, 2, :3] = cfg.bos_token_id
    inputs = rng.integers(0, cfg.vocab_size, (2, 4, 9)).astype(np.int32)
    inputs[1, 1, 4:] = cfg.eos_token_id
    ref = jdecoder.loss_fn(logits, labels, inputs, cfg)
    got = pdecoder.loss_fn(T(logits), T(labels), T(inputs), tiny_config(pcfg).decoder)
    np.testing.assert_allclose(float(got), float(ref), atol=1e-6, rtol=0)


def test_trainable_gradients_match_jax(setup):
    """Every trainable gradient, compared in the JAX layout."""
    jc, _, params, batch = setup
    trainable, frozen = jstep.split_params(params)
    ref = jax.grad(lambda tr: jparler.train_forward(jstep.merge_params(tr, frozen), jc, **batch)[0])(trainable)
    model = _port(params)
    loss, _ = model.train_forward(**{k: T(v) for k, v in batch.items()})
    loss.backward()
    assert all(p.grad is None for p in model.text_encoder.parameters())
    _tree_close(jax.tree.map(np.asarray, ref), to_jax_tree(model, grads=True), GRAD_TOL)


def test_train_step_matches_jax(setup):
    """One full step at fp32: the loss and the global norm of the grads."""
    jc, pc, params, batch = setup
    tx = joptim.make_optimizer(1e-3, warmup_steps=1)
    state, frozen = jstep.create_state({k: v for k, v in params.items() if k != "audio_encoder"}, tx)
    _, ref = jstep.make_train_step(jc, tx, dtype=jnp.float32)(state, frozen, batch)
    pstate = pstep.create_state(port_model(params), learning_rate=1e-3, warmup_steps=1)
    got = pstep.make_train_step(pc, dtype=torch.float32)(pstate, batch)
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]), atol=LOSS_TOL, rtol=0)
    np.testing.assert_allclose(float(got["grad_norm"]), float(ref["grad_norm"]), rtol=1e-5)
    assert got["step"] == int(ref["step"]) == 0 and pstate.step == 1


def test_text_encoder_stays_frozen_and_out_of_autograd(setup):
    """Only the trainable subtrees require grad, and the T5 encoder builds no
    graph even when its parameters would take grads."""
    _, _, params, batch = setup
    model = _port(params)
    assert [k for k in pparler.TRAINABLE_KEYS if getattr(model, k) is not None] == list(pstep.TRAINABLE_KEYS)
    assert not any(p.requires_grad for p in model.text_encoder.parameters())
    assert not any(p.requires_grad for p in model.audio_encoder.parameters())
    model.text_encoder.requires_grad_(True)
    model.encode_text(T(batch["input_ids"]), T(batch["attention_mask"])).sum().backward()
    assert all(p.grad is None for p in model.text_encoder.parameters())
    assert model.enc_to_dec_proj.kernel.grad is not None


def test_to_jax_tree_inverts_load_jax_params(setup):
    _, _, params, _ = setup
    tree = to_jax_tree(_port(params))
    _tree_close({k: params[k] for k in pstep.TRAINABLE_KEYS}, tree, 0)
    other = pparler.init(9, tiny_config(pcfg), device="cpu")
    load_jax_params(other.decoder, tree["decoder"])
    assert torch.equal(other.decoder.layers[1].fc2.kernel, _port(params).decoder.layers[1].fc2.kernel)


# --- schedules and the optimizer ------------------------------------------------


@pytest.mark.parametrize("name,warmup,total", [("constant", 0, None), ("constant_with_warmup", 5, None),
                                               ("constant_with_warmup", 0, None), ("linear", 4, 20),
                                               ("cosine", 4, 20), ("cosine", 0, 10)])
def test_schedules_match_optax(name, warmup, total):
    ref = joptim.make_schedule(name, 3e-3, warmup_steps=warmup, total_steps=total)
    got = poptim.make_schedule(name, 3e-3, warmup_steps=warmup, total_steps=total)
    for count in (0, 1, 2, 3, 4, 5, 9, 10, 15, 19, 20, 25):
        # optax evaluates in fp32, the port in Python floats
        np.testing.assert_allclose(got(count), float(ref(count)), rtol=1e-6, atol=1e-9, err_msg=str(count))
    assert got(0) == 0.0 or name == "constant"  # the first warmup update uses lr 0


def _optimizer_pair(accum, seed=7):
    rng = np.random.default_rng(seed)
    shapes = {"a": (5, 3), "b": (4,), "c": (2, 2, 3)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (3 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()} for _ in range(6)]
    kw = dict(schedule="constant_with_warmup", warmup_steps=2, max_grad_norm=0.5, grad_accum_steps=accum)
    tx = joptim.make_optimizer(1e-2, **kw)
    tensors = {k: torch.tensor(v) for k, v in params.items()}
    opt = poptim.make_optimizer(list(tensors.values()), 1e-2, **kw)
    return params, grads, tx, tensors, opt


@pytest.mark.parametrize("accum,calls", [(1, 3), (2, 6)])
def test_optimizer_matches_optax_on_identical_grads(accum, calls):
    """Clipping active (every global norm is above 0.5), warmup from lr 0,
    AdamW with decoupled decay; with accumulation 2, optax.MultiSteps."""
    params, grads, tx, tensors, opt = _optimizer_pair(accum)
    state = tx.init(params)
    for i in range(calls):
        assert float(optax.global_norm(grads[i])) > 0.5
        updates, state = tx.update(grads[i], state, params)
        params = optax.apply_updates(params, updates)
        applied = opt.update([torch.tensor(grads[i][k]) for k in tensors])
        assert applied == ((i + 1) % accum == 0)
        for k in params:
            np.testing.assert_allclose(tensors[k].numpy(), np.asarray(params[k]), atol=1e-6, rtol=0,
                                       err_msg=f"{k} after call {i}")
    assert opt.count == calls // accum


# --- train mode: dropout, layerdrop, remat ------------------------------------------


def test_dropout_unit_semantics():
    x = torch.ones(1000)
    gen = torch.Generator().manual_seed(1)
    assert pnn.dropout(x, 0.5, None) is x
    assert pnn.dropout(x, 0.0, gen) is x
    y = pnn.dropout(x, 0.25, torch.Generator().manual_seed(1))
    kept = y != 0
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert 0.6 < kept.float().mean() < 0.9
    assert torch.equal(y, pnn.dropout(x, 0.25, torch.Generator().manual_seed(1)))


def _decoder_cfg(**rates):
    cfg = tiny_config(pcfg)
    return dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, **rates))


def _hidden(model, batch, **kw):
    dec = model.decoder
    ids = T(batch["labels"]).clamp(min=0)
    enc = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 7, dec.cfg.hidden_size)).astype(np.float32))
    return dec(ids, encoder_hidden_states=enc, encoder_attention_mask=T(batch["attention_mask"]), **kw)


def test_zero_rates_in_train_mode_equal_eval_exactly(setup):
    _, _, params, batch = setup
    model = port_model(params)
    assert model.cfg.decoder.dropout == 0.0
    h_eval = _hidden(model, batch)
    h_train = _hidden(model, batch, generator=torch.Generator().manual_seed(7))
    assert torch.equal(h_train, h_eval)


def test_dropout_masks_fixed_per_generator_and_varying(setup):
    _, _, _, batch = setup
    model = pparler.init(0, _decoder_cfg(dropout=0.3, attention_dropout=0.1, activation_dropout=0.2),
                         device="cpu")
    h_eval = _hidden(model, batch)
    h1 = _hidden(model, batch, generator=torch.Generator().manual_seed(1))
    h1b = _hidden(model, batch, generator=torch.Generator().manual_seed(1))
    h2 = _hidden(model, batch, generator=torch.Generator().manual_seed(2))
    assert torch.equal(h1, h1b)
    assert (h1 - h2).abs().max() > 0 and (h1 - h_eval).abs().max() > 0


def test_layerdrop_skips_layers(setup):
    """Layerdrop ~1 skips every layer: embeddings + positions through the
    final norm only."""
    _, _, _, batch = setup
    model = pparler.init(0, _decoder_cfg(layerdrop=0.999), device="cpu")
    h = _hidden(model, batch, generator=torch.Generator().manual_seed(3))
    dec = model.decoder
    x = dec.embed_codebooks(T(batch["labels"]).clamp(min=0))
    expect = dec.final_ln(x + dec.positions[None, : x.shape[1]])
    torch.testing.assert_close(h, expect, atol=1e-5, rtol=0)


def test_train_step_masks_fixed_per_seed_and_step(setup):
    """Same step index, same loss; the next step index draws other masks."""
    _, _, _, batch = setup
    cfg = _decoder_cfg(dropout=0.1)
    assert pstep.has_dropout(cfg) and not pstep.has_dropout(tiny_config(pcfg))
    step = pstep.make_train_step(cfg, dtype=torch.float32, dropout_seed=0)
    losses = []
    for at in (0, 0, 1):
        state = pstep.create_state(pparler.init(0, cfg, device="cpu"), learning_rate=1e-3, warmup_steps=1)
        state.step = at
        losses.append(float(step(state, batch)["loss"]))
    assert losses[0] == losses[1] != losses[2]


@pytest.mark.parametrize("rates", [dict(), dict(dropout=0.1, layerdrop=0.3, attention_dropout=0.1)])
def test_remat_gives_the_same_gradients(setup, rates):
    """Per-layer recomputation replays the same dropout masks."""
    _, _, params, batch = setup
    cfg = _decoder_cfg(**rates)
    grads = []
    for remat in (False, True):
        model = pparler.init(1, cfg, device="cpu")
        pparler.set_trainable(model)
        loss, _ = model.train_forward(**{k: T(v) for k, v in batch.items()},
                                      generator=torch.Generator().manual_seed(7), remat=remat)
        loss.backward()
        grads.append((loss.item(), to_jax_tree(model, grads=True)))
    assert grads[0][0] == pytest.approx(grads[1][0], rel=1e-6)
    _tree_close(grads[0][1], grads[1][1], 1e-6)
