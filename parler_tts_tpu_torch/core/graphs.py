"""CUDA-graph capture, shared by the port's captured programs: the decode
steps and prefills of ``generation/generate.py`` and the train and eval
steps of ``training/step.py`` (the JAX package's jitted programs).

``record`` runs a function once as its warm-up and then captures it into a
graph on a memory pool.  A capture registers generators whose draws the
graph replays: the default CUDA generator always, and the caller's.  When a
capture fails, each of them is left mid-capture (torch ends the capture
before the generators' epilogue runs), and every later draw from it in the
process would raise; so ``record`` gives each a fresh copy of its state
(``graphsafe_set_state(clone_state())``) and raises the failure.

``Programs`` keeps one owner's captured programs by signature within a
byte budget, the least recently used dropped first."""

from __future__ import annotations

import collections
from typing import Any, Callable, Hashable, Iterable

import torch

#: the captured programs of one owner (a model's decode states, a train
#: state's steps, a model's eval steps) hold at most this share of the
#: card's memory; the least recently used go first
GRAPH_MEMORY_SHARE = 0.25


def new_pool():
    return torch.cuda.graph_pool_handle()


def budget(device: torch.device) -> float:
    """Bytes the captured programs of one owner may hold."""
    return GRAPH_MEMORY_SHARE * torch.cuda.get_device_properties(device).total_memory


def _restore(generators: Iterable[torch.Generator]) -> None:
    for gen in (torch.cuda.default_generators[torch.cuda.current_device()], *generators):
        gen.graphsafe_set_state(gen.clone_state())


def record(fn: Callable[[], None], pool, generators: Iterable[torch.Generator] = ()
           ) -> tuple[torch.cuda.CUDAGraph, int]:
    """``fn()`` once on the stream ``torch.cuda.graph`` captures on, then
    captured there into a graph on ``pool``, with ``generators`` (CUDA
    generators that ``fn`` draws from, seeded by the caller before each
    replay) registered: library set-up (handles, workspaces) stays out of
    the capture and is made once for that stream.  The capture runs nothing,
    so what the warm-up wrote stays.  Returns the graph and the bytes the
    capture reserved for the pool (the allocator's reserved bytes around
    it, after the cached blocks are freed: a capture allocates from the pool
    alone).  A failed capture restores every registered generator (see the
    module docstring) and raises."""
    generators = list(generators)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.graph(graph).capture_stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # as torch.cuda.graph does before a capture
    reserved = torch.cuda.memory_reserved()
    try:
        with torch.cuda.stream(side):
            for gen in generators:
                graph.register_generator_state(gen)
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                fn()
            finally:
                graph.capture_end()
    except BaseException:
        _restore(generators)
        raise
    torch.cuda.synchronize()
    return graph, torch.cuda.memory_reserved() - reserved


class Programs:
    """One owner's captured programs by signature, the most recently used
    last, with what they cost: each program has ``nbytes``; ``captures``,
    ``capture_seconds`` and ``replays`` count over the owner's life.  A
    copied owner captures its own."""

    def __init__(self):
        self._by_key: collections.OrderedDict[Hashable, Any] = collections.OrderedDict()
        self.captures = self.replays = 0
        self.capture_seconds = 0.0

    def __deepcopy__(self, memo) -> "Programs":
        return Programs()

    def __len__(self) -> int:
        return len(self._by_key)

    @property
    def nbytes(self) -> int:
        return sum(p.nbytes for p in self._by_key.values())

    def get(self, key: Hashable):
        """The program of ``key`` as the most recently used, or None."""
        program = self._by_key.get(key)
        if program is not None:
            self._by_key.move_to_end(key)
        return program

    def add(self, key: Hashable, program, seconds: float, limit: float) -> None:
        """``program``, captured in ``seconds``, as the most recently used;
        then the least recently used others are dropped until the rest hold
        at most ``limit`` bytes (the newest is kept even alone over it)."""
        self._by_key[key] = program
        self.captures += 1
        self.capture_seconds += seconds
        for old in list(self._by_key)[:-1]:
            if self.nbytes <= limit:
                return
            del self._by_key[old]

