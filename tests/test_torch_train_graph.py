"""The captured train and eval steps (``training/step.py``) on the CPU.

On a CUDA model in one process the steps are CUDA graphs, captured per
signature and replayed.  Here the captured route runs with CPU stand-ins
for the graph functions, as ``tests/test_torch_stream_loop.py`` runs the
captured decode loop: recording runs the step once (the warm-up, which is
the capturing call's step, since a capture runs nothing), and a "replay"
runs it again over the static inputs.  So the route's host side (static
inputs and outputs, the dropout seeds and layerdrop draws kept outside the
graph, the optimizer's staged learning rate and accumulation, signatures,
resume) meets the eager step bit for bit: losses, gradient norms,
parameters and optimizer state, with dropout, attention dropout,
layerdrop, remat, accumulation over 2 micro-batches and a resume mid-run,
on the dummy config at fp32.  At dropout 0 both routes are held against
JAX's jitted ``make_train_step`` and ``make_eval_step`` within
``tests/test_torch_train.py``'s tolerances, and the optimizer's capturable
form (the card's) against optax.  The card's own checks are
``tests/test_torch_cuda.py``'s."""

from __future__ import annotations

import copy
import dataclasses
import importlib
import io
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from parler_tts_tpu.core import config as jcfg
from parler_tts_tpu.training import optim as joptim
from parler_tts_tpu.training import step as jstep
from parler_tts_tpu_torch.core import config as pcfg
from parler_tts_tpu_torch.core import graphs as pgraphs
from parler_tts_tpu_torch.core.from_jax import to_jax_tree
from parler_tts_tpu_torch.models import decoder as pdecoder
from parler_tts_tpu_torch.models import parler as pparler
from parler_tts_tpu_torch.training import data as pdata
from parler_tts_tpu_torch.training import optim as poptim
from parler_tts_tpu_torch.training import run_training as prun
from parler_tts_tpu_torch.training import step as pstep
from tests.test_torch_blocks import jax_params, port_model, tiny_config
from tests.test_torch_run_training import _artifact, _dropout_artifact, _main, _records, _spy_batches, _train
from tests.test_torch_train import GRAD_TOL, LOSS_TOL, _batch, _optimizer_pair, _tree_close

torch.set_num_threads(1)  # tier-1 runs several pytest workers


class _Graph:
    def __init__(self, fn):
        self.replay = fn


def _eager(device, groups=()) -> bool:
    return False


@pytest.fixture
def captured_route(monkeypatch):
    """The captured route on the CPU (module docstring).  Returns the list
    of the generators each recording registered."""
    registered = []

    def record(fn, pool, generators=()):
        registered.append(list(generators))
        fn()
        return _Graph(fn), 0

    monkeypatch.setattr(pgraphs, "record", record)
    monkeypatch.setattr(pgraphs, "new_pool", lambda: None)
    monkeypatch.setattr(pgraphs, "budget", lambda device: float("inf"))
    monkeypatch.setattr(pgraphs, "capturable", lambda device, groups=(): all(g is None for g in groups))
    return registered


@pytest.fixture(scope="module")
def dummy():
    """The dummy config's model (seed 0) and two batches of two rows of the
    same shapes (left-padded prompts, ragged labels)."""
    cfg = pcfg.dummy_config()
    model = pparler.init(0, cfg, device="cpu")
    batches = []
    for seed in (0, 1):
        samples = prun.prepare_synthetic(2, cfg, seed=seed, desc_len=12, prompt_len=10, codes_len=24)
        batches.append(pdata.Collator(0, 0, 12, 10, 24 + cfg.decoder.num_codebooks + 2)(samples))
    return cfg, model, batches


def _with_rates(cfg, **rates):
    return dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, **rates))


def _state(model, cfg, accum: int = 1) -> pstep.TrainState:
    model = copy.deepcopy(model)
    model.cfg = cfg
    model.decoder.cfg = cfg.decoder
    for layer in model.decoder.layers:
        layer.dropout, layer.attention_dropout = cfg.decoder.dropout, cfg.decoder.attention_dropout
        layer.activation_dropout = cfg.decoder.activation_dropout
    return pstep.create_state(model, learning_rate=1e-3, warmup_steps=2, grad_accum_steps=accum)


def _run(state, step, batches, n):
    return [(m["loss"].clone(), m["grad_norm"].clone(), m["step"])
            for m in (step(state, batches[i % len(batches)]) for i in range(n))]


def _assert_same(a: pstep.TrainState, b: pstep.TrainState) -> None:
    for name, p in a.model.named_parameters():
        assert torch.equal(p, dict(b.model.named_parameters())[name]), name
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert (sa["count"], sa["mini_step"]) == (sb["count"], sb["mini_step"])
    for i, s in sa["adamw"]["state"].items():
        for key, value in s.items():
            assert torch.equal(value, sb["adamw"]["state"][i][key]), (i, key)
    assert a.step == b.step


DROPOUT = dict(dropout=0.1, attention_dropout=0.1, activation_dropout=0.1, layerdrop=0.3)


@pytest.mark.parametrize("rates,remat,accum,steps", [
    (DROPOUT, False, 1, 5),
    (DROPOUT, True, 1, 5),
    (DROPOUT, False, 2, 6),
    (dict(dropout=0.0), True, 1, 3),
], ids=["dropout_layerdrop", "dropout_layerdrop_remat", "accumulation_2", "no_dropout_remat"])
def test_captured_steps_equal_the_eager_steps_bit_for_bit(dummy, captured_route, rates, remat, accum, steps):
    """The same steps on both routes from the same state: every loss and
    gradient norm, then the parameters and the optimizer state, equal.  One
    capture per signature (an accumulating and an updating one with
    accumulation), replays after; with dropout, each layer's generators
    (two with remat) and the embedded sequence's are registered.  The
    layerdrop draws of these steps skip some layers and keep others."""
    base_cfg, model, batches = dummy
    cfg = _with_rates(base_cfg, **rates)
    make = dict(dtype=torch.float32, dropout_seed=0, remat=remat)
    eager, captured = _state(model, cfg, accum), _state(model, cfg, accum)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pgraphs, "capturable", _eager)
        want = _run(eager, pstep.make_train_step(cfg, **make), batches, steps)
    got = _run(captured, pstep.make_train_step(cfg, **make), batches, steps)
    for (loss, norm, at), (ref_loss, ref_norm, ref_at) in zip(got, want):
        assert at == ref_at and torch.equal(loss, ref_loss) and torch.equal(norm, ref_norm), at
    _assert_same(captured, eager)
    signatures = 2 if accum > 1 else 1
    assert (captured.graphs.captures, captured.graphs.replays) == (signatures, steps - signatures)
    assert eager.graphs.captures == 0
    layers = cfg.decoder.num_hidden_layers
    if pstep.has_dropout(cfg):
        assert [len(g) for g in captured_route] == [layers * (2 if remat else 1) + 1] * signatures
    if cfg.decoder.layerdrop:
        keeps = [pdecoder.train_draws(pstep.dropout_generator(0, s), layers, cfg.decoder.layerdrop)[1]
                 for s in range(steps)]
        assert any(all(k) for k in keeps) and any(not all(k) for k in keeps)


def test_replays_draw_new_masks_and_a_load_copies_into_the_live_state(dummy, captured_route):
    """With dropout, a replayed step at another index draws other masks
    (the same batch gives another loss); an optimizer state and parameters
    loaded into a state whose steps are captured are copied into its
    tensors, so the graphs replay on (nothing is captured again) and the
    steps after the load repeat the ones after the save."""
    base_cfg, model, batches = dummy
    cfg = _with_rates(base_cfg, **DROPOUT)
    state = _state(model, cfg)
    step = pstep.make_train_step(cfg, dtype=torch.float32, dropout_seed=0, remat=True)
    first = _run(state, step, batches[:1], 3)
    assert len({float(loss) for loss, _, _ in first}) == 3
    buf = io.BytesIO()
    torch.save({"opt": state.optimizer.state_dict(), "params": {k: v.clone() for k, v in
                                                                 state.model.state_dict().items()}}, buf)
    at = state.step
    after = _run(state, step, batches, 3)
    saved = torch.load(io.BytesIO(buf.getvalue()), weights_only=True)
    with torch.no_grad():
        for name, p in state.model.named_parameters():
            p.copy_(saved["params"][name])
    state.optimizer.load_state_dict(saved["opt"])
    state.step = at
    again = _run(state, step, batches, 3)
    assert state.graphs.captures == 1 and state.graphs.replays == 8
    for (loss, norm, _), (ref_loss, ref_norm, _) in zip(again, after):
        assert torch.equal(loss, ref_loss) and torch.equal(norm, ref_norm)


def test_the_cli_resumes_on_the_captured_route_bit_for_bit(tmp_path, monkeypatch, captured_route):
    """``run_training.main`` on the captured route (dropout on, 3 steps per
    epoch): a run to 2 and a resume to 4 take the eager straight run's
    batches, losses, gradient norms and final parameters, bit for bit."""
    art = _dropout_artifact(tmp_path / "art")
    seen = _spy_batches(monkeypatch)
    common = ("--train_dataset_name", "synthetic://6", "--save_steps", "2", "--warmup_steps", "1")
    _main(art, tmp_path / "split", "--max_steps", "2", *common)
    _main(art, tmp_path / "split", "--max_steps", "4", *common)
    split = list(seen)
    seen.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pgraphs, "capturable", _eager)
        _main(art, tmp_path / "eager", "--max_steps", "4", *common)
    assert seen == split and len(set(split)) == 4
    a, b = _train(tmp_path / "eager"), _train(tmp_path / "split")
    assert [r["step"] for r in b] == [1, 2, 3, 4]
    assert [r["train/loss"] for r in a] == [r["train/loss"] for r in b]
    assert [r["train/grad_norm"] for r in a] == [r["train/grad_norm"] for r in b]
    wa = torch.load(tmp_path / "eager" / "final" / "weights.pt", weights_only=True)
    wb = torch.load(tmp_path / "split" / "final" / "weights.pt", weights_only=True)
    assert wa.keys() == wb.keys() and all(torch.equal(wa[k], wb[k]) for k in wa)


def test_the_cli_eval_replays_its_captured_pass(tmp_path, captured_route):
    """The CLI's eval loss on the captured route: the eval step's graph is
    captured once per batch shape and replayed, with the eager route's
    loss."""
    art = _artifact(tmp_path / "art")
    argv = ("--max_steps", "2", "--do_eval", "--eval_steps", "2", "--max_eval_samples", "5",
            "--per_device_eval_batch_size", "2", "--generation_max_length", "0")
    _main(art, tmp_path / "captured", *argv)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pgraphs, "capturable", _eager)
        _main(art, tmp_path / "eager", *argv)
    losses = [[r["eval/loss"] for r in _records(tmp_path / name) if "eval/loss" in r]
              for name in ("captured", "eager")]
    assert losses[0] == losses[1] and len(losses[0]) == 1


def test_eval_steps_capture_per_batch_shape(dummy, captured_route):
    """One graph per batch shape, kept on the model: each replay gives the
    eager pass's loss bit for bit."""
    cfg, model, batches = dummy
    model = copy.deepcopy(model)
    step = pstep.make_eval_step(cfg, dtype=torch.float32)
    short = {k: v[:1] for k, v in batches[0].items()}
    got = [step(model, b)["loss"] for b in (batches[0], batches[1], short, batches[0])]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pgraphs, "capturable", _eager)
        want = [step(model, b)["loss"] for b in (batches[0], batches[1], short, batches[0])]
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    graphs = pstep._eval_graphs(model)
    assert (graphs.captures, graphs.replays, len(graphs)) == (2, 2, 2)
    assert len(pstep._eval_graphs(copy.deepcopy(model))) == 0


@pytest.fixture(scope="module")
def tiny():
    jc, pc = tiny_config(jcfg), tiny_config(pcfg)
    return jc, pc, jax_params(jc), _batch(jc)


@pytest.mark.parametrize("route", ["eager", "captured"])
def test_both_routes_match_jax_jitted_steps(tiny, captured_route, monkeypatch, route):
    """Dropout 0: three train steps and an eval pass on each route against
    JAX's jitted ``make_train_step`` and ``make_eval_step`` (losses within
    ``LOSS_TOL``, gradient norms within 1e-5 relative, the trained
    parameters within ``GRAD_TOL``)."""
    jc, pc, params, batch = tiny
    if route == "eager":
        monkeypatch.setattr(pgraphs, "capturable", _eager)
    tx = joptim.make_optimizer(1e-3, warmup_steps=1)
    state, frozen = jstep.create_state({k: v for k, v in params.items() if k != "audio_encoder"}, tx)
    jtrain = jax.jit(jstep.make_train_step(jc, tx, dtype=jnp.float32))
    jeval = jax.jit(jstep.make_eval_step(jc, dtype=jnp.float32))
    pstate = pstep.create_state(port_model(params), learning_rate=1e-3, warmup_steps=1)
    ptrain, peval = pstep.make_train_step(pc, dtype=torch.float32), pstep.make_eval_step(pc, dtype=torch.float32)
    for _ in range(3):
        state, ref = jtrain(state, frozen, batch)
        got = ptrain(pstate, batch)
        np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]), atol=LOSS_TOL, rtol=0)
        np.testing.assert_allclose(float(got["grad_norm"]), float(ref["grad_norm"]), rtol=1e-5)
    np.testing.assert_allclose(float(peval(pstate.model, batch)["loss"]),
                               float(jeval(jstep.merge_params(state.params, frozen), batch)["loss"]),
                               atol=LOSS_TOL, rtol=0)
    _tree_close(jax.tree.map(np.asarray, state.params), to_jax_tree(pstate.model), GRAD_TOL)
    assert pstate.graphs.captures == (route == "captured")


@pytest.mark.parametrize("accum,calls", [(1, 3), (2, 6)])
def test_capturable_optimizer_matches_optax_on_identical_grads(monkeypatch, accum, calls):
    """The optimizer's form on the card (torch's capturable AdamW, its step
    counts and learning rate as tensors, foreach) run on the CPU, against
    optax as ``test_optimizer_matches_optax_on_identical_grads``."""
    monkeypatch.setattr(poptim, "capturable", lambda device: True)
    monkeypatch.setattr(importlib.import_module("torch.optim.adam"), "_get_capturable_supported_devices",
                        lambda supports_xla=True: ["cuda", "cpu"])
    params, grads, tx, tensors, opt = _optimizer_pair(accum)
    assert opt._adamw.param_groups[0]["capturable"] and torch.is_tensor(opt._adamw.param_groups[0]["lr"])
    state = tx.init(params)
    for i in range(calls):
        updates, state = tx.update(grads[i], state, params)
        params = optax.apply_updates(params, updates)
        assert opt.update([torch.tensor(grads[i][k]) for k in tensors]) == ((i + 1) % accum == 0)
        for k in params:
            np.testing.assert_allclose(tensors[k].numpy(), np.asarray(params[k]), atol=1e-6, rtol=0,
                                       err_msg=f"{k} after call {i}")
    assert opt.count == calls // accum
    assert isinstance(opt.state_dict()["adamw"]["param_groups"][0]["lr"], float)


def test_programs_keep_the_newest_within_their_budget():
    class P:
        def __init__(self, nbytes):
            self.nbytes = nbytes

    programs = pgraphs.Programs()
    programs.add("a", P(4), 0.5, limit=10)
    programs.add("b", P(4), 0.25, limit=10)
    assert programs.get("a") is not None  # a is now the most recently used
    programs.add("c", P(4), 0.25, limit=10)
    assert programs.get("b") is None and len(programs) == 2 and programs.nbytes == 8
    programs.add("d", P(20), 0.0, limit=10)
    assert len(programs) == 1 and programs.get("d") is not None
    assert (programs.captures, programs.capture_seconds) == (4, 1.0)


def test_programs_never_drop_a_leased_entry():
    """``instance`` hands out the first entry of a signature that no one
    leases, making one when there is none; ``make_room`` and ``add`` drop
    the least recently used entries, never a leased one."""
    class P:
        def __init__(self, nbytes):
            self.nbytes = nbytes

    programs = pgraphs.Programs()
    key, first = programs.instance("s", lambda: P(4))
    assert key == ("s", 0) and programs.instance("s", lambda: P(4)) == (key, first)
    programs.leased.add(key)
    second_key, second = programs.instance("s", lambda: P(4))
    assert second_key == ("s", 1) and second is not first and len(programs) == 2
    assert programs.make_room(4, limit=4) == 1 and programs.get(key) is first and second_key not in programs
    programs.add("t", P(4), 0.0, limit=0)
    assert key in programs and "t" in programs and len(programs) == 2
    programs.leased.discard(key)
    assert programs.make_room(0, limit=4) == 1 and key not in programs and len(programs) == 1


@pytest.mark.parametrize("replays", [1, 3], ids=["one_replay", "three_replays_counted_at_once"])
def test_replays_add_the_launches_their_graphs_hold(monkeypatch, replays):
    """A kernel call under a capture goes to the capturing program's
    tally, not to the launch counters, also from another thread (autograd
    runs a captured backward on its own); a replay adds the program's
    launches, and ``replayed(n)`` those of n replays at once, as a decode
    segment adds them.  The function captured here counts two kernels."""
    def fn():
        pgraphs.count("flash_attention_fwd")
        worker = threading.Thread(target=lambda: [pgraphs.count("decode_attention") for _ in range(2)])
        worker.start()
        worker.join(timeout=30)
        assert not worker.is_alive()

    def record(fn, pool, generators=()):
        with monkeypatch.context() as mp:  # the capture: each call records, none launches
            mp.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
            fn()
        return _Graph(lambda: None), 0

    monkeypatch.setattr(pgraphs, "record", record)
    monkeypatch.setattr(pgraphs, "new_pool", lambda: None)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    before = pgraphs.launches()
    program = pgraphs.capture(fn)
    assert pgraphs.launches() == before
    assert program.launches == {"flash_attention_fwd": 1, "flash_attention_dq": 0, "flash_attention_dkv": 0,
                                "flash_attention_dqkv": 0, "decode_attention": 2, "snake": 0,
                                "dac_conv": 0, "ssm_step": 0, "norm": 0}
    fn()  # an eager call launches
    assert pgraphs.launches()["decode_attention"] == before["decode_attention"] + 2
    before = pgraphs.launches()
    if replays == 1:
        program.replay()
    else:
        program.replayed(replays)
    moved = {k: n - before[k] for k, n in pgraphs.launches().items()}
    assert moved == {k: n * replays for k, n in program.launches.items()}
