"""CUDA graphs: the one owner of the port's captured programs, the decode
steps and prefills of ``generation/generate.py`` and the train and eval
steps of ``training/step.py`` (the JAX package's jitted programs).

``capturable`` says where programs are captured: a CUDA device and no
process group to sum over (gloo collectives cannot be captured, and a
capture of NCCL collectives over several ranks cannot be checked on the one
card there is).  ``capture`` records a function (``record``) into a
:class:`Program`; ``Programs`` keeps one owner's programs by key within a
byte budget, the least recently used dropped first, never one that is
leased.

The hand-written kernels (``KERNELS``: K1-K4 in ``ops/flash_attention.py``,
K5 in ``ops/decode_attention.py``, K6 in ``ops/snake.py``, K7 in
``ops/dac_conv.py``, K8 in ``ops/ssm.py``, K9 in ``ops/norm.py``) count each
call through ``count``: a launch, or, while a stream is captured, a launch of the
capturing program, which each replay then adds (``Program.replayed``).  So
``launches()`` reads every launch, eager or replayed.  The plain versions
and the CPU path count nothing."""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Callable, Hashable, Iterable

import torch

#: the captured programs of one owner (a model's decode states, a train
#: state's steps, a model's eval steps) hold at most this share of the
#: card's memory; the least recently used go first
GRAPH_MEMORY_SHARE = 0.25

#: the hand-written kernels, each with its launch counter
KERNELS = ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv", "flash_attention_dqkv",
           "decode_attention", "snake", "dac_conv", "ssm_step", "norm")

_launches = dict.fromkeys(KERNELS, 0)
# the launches of the program being captured; a module global, not a
# thread's, since autograd runs a captured backward on its own threads
_tally: dict[str, int] | None = None


def capturable(device: torch.device, groups: Iterable = ()) -> bool:
    """Whether programs on ``device`` are captured: a CUDA device, and none
    of ``groups`` (the process groups the program would sum over) set."""
    return device.type == "cuda" and all(group is None for group in groups)


def count(kernel: str) -> None:
    """One call of the hand-written ``kernel``: a launch, or under a capture
    a launch of the capturing program."""
    if torch.cuda.is_current_stream_capturing():
        if _tally is not None:
            _tally[kernel] += 1
    else:
        _launches[kernel] += 1


def launches() -> dict[str, int]:
    """Each hand-written kernel's launches so far, by its name."""
    return dict(_launches)


def new_pool():
    return torch.cuda.graph_pool_handle()


def budget(device: torch.device) -> float:
    """Bytes the captured programs of one owner may hold."""
    return GRAPH_MEMORY_SHARE * torch.cuda.get_device_properties(device).total_memory


def _restore(generators: Iterable[torch.Generator]) -> None:
    """A failed capture leaves each registered generator mid-capture (torch
    ends the capture before the generators' epilogue runs), and every later
    draw from it in the process would raise: each gets a fresh copy of its
    state."""
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
    alone).  A failed capture restores every registered generator
    (``_restore``; the default CUDA generator too) and raises."""
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


@dataclasses.dataclass
class Program:
    """A captured function: its graph, the bytes its capture reserved, the
    seconds its warm-up and capture took, and the kernel launches one
    replay makes (by kernel name)."""

    graph: torch.cuda.CUDAGraph
    nbytes: int
    seconds: float
    launches: dict[str, int]

    def replay(self) -> None:
        self.graph.replay()
        self.replayed(1)

    def replayed(self, times: int) -> None:
        """Count the launches of ``times`` replays made through ``graph``
        (a loop that replays step by step counts once)."""
        for kernel, n in self.launches.items():
            _launches[kernel] += n * times


def capture(fn: Callable[[], None], pool=None, generators: Iterable[torch.Generator] = ()) -> Program:
    """``fn`` recorded (``record``) on ``pool``, else on a pool of its own:
    its warm-up launches, its capture's kernel calls go to the program."""
    global _tally
    t0, tally = time.perf_counter(), dict.fromkeys(KERNELS, 0)
    pool = new_pool() if pool is None else pool
    _tally = tally
    try:
        graph, nbytes = record(fn, pool, generators)
    finally:
        _tally = None
    return Program(graph, nbytes, time.perf_counter() - t0, tally)


class Programs:
    """One owner's captured programs by key, the most recently used last,
    each with its ``nbytes``; ``captures``, ``capture_seconds`` and
    ``replays`` count over the owner's life.  An entry whose key is in
    ``leased`` is neither dropped nor handed out by ``instance``.  ``lock``
    is held by whoever runs on the programs.  A copied owner captures its
    own."""

    def __init__(self):
        self._by_key: collections.OrderedDict[Hashable, Any] = collections.OrderedDict()
        self.leased: set[Hashable] = set()
        self.lock = threading.Lock()
        self.captures = self.replays = 0
        self.capture_seconds = 0.0

    def __deepcopy__(self, memo) -> "Programs":
        return Programs()

    def __len__(self) -> int:
        return len(self._by_key)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._by_key

    @property
    def nbytes(self) -> int:
        return sum(p.nbytes for p in self._by_key.values())

    def get(self, key: Hashable):
        """The entry of ``key`` as the most recently used, or None."""
        entry = self._by_key.get(key)
        if entry is not None:
            self._by_key.move_to_end(key)
        return entry

    def add(self, key: Hashable, entry, seconds: float, limit: float) -> None:
        """``entry``, captured in ``seconds``, as the most recently used,
        after room is made for its bytes within ``limit`` (it is kept even
        alone over it)."""
        self.make_room(entry.nbytes, limit)
        self._by_key[key] = entry
        self.captures += 1
        self.capture_seconds += seconds

    def make_room(self, nbytes: int, limit: float) -> int:
        """Drop the least recently used entries until ``nbytes`` more fit
        in ``limit`` bytes, or none is left to drop; returns how many
        went."""
        dropped = 0
        for key in list(self._by_key):
            if self.nbytes + nbytes <= limit:
                break
            if key not in self.leased:
                del self._by_key[key]
                dropped += 1
        return dropped

    def instance(self, signature: Hashable, make: Callable[[], Any]) -> tuple[Hashable, Any]:
        """The first entry of ``signature`` that no one leases (keyed
        ``(signature, i)``), made by ``make()`` when there is none, as the
        most recently used: its key and the entry."""
        i = 0
        while (signature, i) in self.leased:
            i += 1
        key = (signature, i)
        if key not in self._by_key:
            self._by_key[key] = make()
        self._by_key.move_to_end(key)
        return key, self._by_key[key]
