"""Sparse mixture of experts: a sigmoid router over routed experts, SwiGLU
(LFM2) or relu2 (Nemotron-H), of which a card may hold a share.

No TPU kernel or JAX counterpart: the LFM2 and Nemotron-H block families
(``models/lfm2.py``, ``models/nemotron_h.py``) exist only in the port.
Routing (the published LFM2-MoE and NemotronH blocks): ``s = sigmoid(x @
router)`` in fp32 (Nemotron-H takes the product itself in fp32); a token's
experts are the top ``k`` of ``s + expert_bias``; their weights are the
picked ``s``, over their sum + ``eps`` (LFM2 1e-6, Nemotron-H 1e-20) when
``norm_topk_prob``, times ``scaling``.  Every routed (token, expert) pair of
an expert held here is computed: no capacity, nothing dropped, and no
expert runs on a token not routed to it.  LFM2's expert ``e`` is
``(silu(x @ w_in[e][:, :F]) * (x @ w_in[e][:, F:])) @ w_out[e]`` with
``w_in`` (E, H, 2F); Nemotron-H's is ``relu(x @ w_in[e])**2 @ w_out[e]``
with ``w_in`` (E, H, F); ``w_out`` is (E, F, H).  A token's output is the
weighted sum of its experts' outputs, taken in fp32.

Expert parallelism: with ``first`` given, ``w_in`` and ``w_out`` hold the
experts ``[first, first + E)`` of the router's; a pair routed to an expert
held elsewhere is neither multiplied nor added here, and is counted apart
(not as dropped).  The card's output is its experts' part of the result.
With ``first`` None every expert is held.

:func:`experts` runs the plain version on CPU tensors (a loop over the
experts, each on the tokens routed to it) and the grouped one on CUDA
tensors: the pairs sorted by expert on the device (those held elsewhere
last), one grouped matrix product per projection over all experts
(``torch._grouped_mm`` with device offsets), the outputs put back in token
order and summed.  Its shapes are static and it reads nothing on the host,
so a CUDA graph captures it.

``stats``, an int64 tensor on the device, accumulates the routed pairs,
the experts held here that got at least one token and the pairs dropped (0
by construction: the held experts' counts, and the pairs held elsewhere,
are checked against the pairs); with ``first`` given it has a fourth
entry, the pairs routed to experts held elsewhere.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

def route(x: torch.Tensor, router: torch.Tensor, expert_bias: torch.Tensor | None, k: int, *,
          norm_topk_prob: bool = True, scaling: float = 1.0, fp32_logits: bool = False,
          eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """x (T, H), router (H, E) -> (weights (T, k) fp32, experts (T, k) int64).
    ``fp32_logits``: the router's product in fp32, not x's dtype."""
    logits = torch.matmul(x.float(), router.float()) if fp32_logits else torch.matmul(x, router.to(x.dtype)).float()
    scores = torch.sigmoid(logits)
    choice = scores if expert_bias is None else scores + expert_bias.float()
    experts = torch.topk(choice, k, dim=-1).indices
    weights = torch.gather(scores, 1, experts)
    if norm_topk_prob:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + eps)
    return weights * scaling, experts


def _local(experts: torch.Tensor, held: int, first: int | None) -> torch.Tensor:
    """Each pair's expert among those held here, ``held`` for one held
    elsewhere (none with ``first`` None)."""
    if first is None:
        return experts
    local = experts - first
    return torch.where((local >= 0) & (local < held), local, held)


def _count(stats: torch.Tensor | None, local: torch.Tensor, held: int, first: int | None) -> torch.Tensor:
    """The held experts' pair counts; ``local`` as ``_local`` gives it."""
    flat = local.reshape(-1)  # bincount would read its length on the host
    size = held if first is None else held + 1  # the last: pairs held elsewhere
    counts = torch.zeros(size, dtype=torch.int64, device=flat.device).scatter_add_(0, flat, torch.ones_like(flat))
    if stats is not None:
        pairs = local.numel()
        if first is None:
            stats += torch.stack([torch.full_like(counts[0], pairs), (counts > 0).sum(), pairs - counts.sum()])
        else:
            elsewhere, mine = counts[held], counts[:held]
            stats += torch.stack([torch.full_like(elsewhere, pairs), (mine > 0).sum(),
                                  pairs - mine.sum() - elsewhere, elsewhere])
    return counts[:held]


def _swiglu(h: torch.Tensor) -> torch.Tensor:
    f = h.shape[-1] // 2
    return F.silu(h[..., :f]) * h[..., f:]


def relu2(h: torch.Tensor) -> torch.Tensor:
    """Nemotron-H's expert activation, relu(h)**2, squared in fp32."""
    return torch.relu(h).float().square().to(h.dtype)


def experts_plain(x: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor, weights: torch.Tensor,
                  experts: torch.Tensor, stats: torch.Tensor | None = None, *, act=_swiglu,
                  first: int | None = None) -> torch.Tensor:
    """The loop over the held experts: x (T, H) -> (T, H) in x's dtype."""
    held = w_in.shape[0]
    local = _local(experts, held, first)
    _count(stats, local, held, first)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(held):
        token, slot = torch.nonzero(local == e, as_tuple=True)
        if token.numel() == 0:
            continue
        y = torch.matmul(act(torch.matmul(x[token], w_in[e].to(x.dtype))), w_out[e].to(x.dtype))
        out.index_add_(0, token, y.float() * weights[token, slot, None])
    return out.to(x.dtype)


def experts_grouped(x: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor, weights: torch.Tensor,
                    experts: torch.Tensor, stats: torch.Tensor | None = None, *, act=_swiglu,
                    first: int | None = None) -> torch.Tensor:
    """The grouped route: static shapes, no host read.  x (T, H) -> (T, H).
    Pairs held elsewhere sort after every group, past the last offset, where
    the grouped products leave their rows unwritten; their outputs are not
    read."""
    t, k = experts.shape
    held = w_in.shape[0]
    local = _local(experts, held, first)
    order = torch.argsort(local.reshape(-1), stable=True)  # pairs by expert, then by token
    offs = torch.cumsum(_count(stats, local, held, first), 0, dtype=torch.int32)
    h = torch._grouped_mm(x.index_select(0, order // k), w_in, offs=offs)
    y = torch._grouped_mm(act(h), w_out, offs=offs)
    y = torch.empty_like(y).index_copy_(0, order, y).view(t, k, -1)  # back to (token, slot) order
    y = y.float() * weights[..., None]
    if first is not None:
        y = torch.where((local < held)[..., None], y, 0.0)
    return y.sum(dim=1).to(x.dtype)


def experts(x: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor, weights: torch.Tensor, experts: torch.Tensor,
            stats: torch.Tensor | None = None, *, act=_swiglu, first: int | None = None) -> torch.Tensor:
    """The held experts' weighted sum for each token: the plain version on
    CPU tensors, the grouped one on CUDA tensors."""
    fn = experts_grouped if x.is_cuda else experts_plain
    return fn(x, w_in, w_out, weights, experts, stats, act=act, first=first)
