"""Sparse mixture of experts: LFM2's sigmoid router and its SwiGLU experts.

No TPU kernel or JAX counterpart: the LFM2 block family
(``models/lfm2.py``) exists only in the port.  Routing (the published
LFM2-MoE block): ``s = sigmoid(x @ router)`` in fp32; a token's experts are
the top ``k`` of ``s + expert_bias``; their weights are the picked ``s``,
over their sum + 1e-6 when ``norm_topk_prob``, times ``scaling``.  Every
routed (token, expert) pair is computed: no capacity, nothing dropped, and no
expert runs on a token not routed to it.  Expert ``e`` is
``(silu(x @ w13[e][:, :F]) * (x @ w13[e][:, F:])) @ w2[e]`` with ``w13`` (E,
H, 2F) and ``w2`` (E, F, H); a token's output is the weighted sum of its
experts' outputs, taken in fp32.

:func:`experts` runs the plain version on CPU tensors (a loop over the
experts, each on the tokens routed to it) and the grouped one on CUDA
tensors: the pairs sorted by expert on the device, one grouped matrix
product per projection over all experts (``torch._grouped_mm`` with device
offsets), the outputs put back in token order and summed.  Its shapes are
static and it reads nothing on the host, so a CUDA graph captures it.

``stats``, an int64 (3,) tensor on the device, accumulates the routed
pairs, the experts that got at least one token, and the pairs dropped (0 by
construction: the sum of the experts' counts is checked against the pairs).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

def route(x: torch.Tensor, router: torch.Tensor, expert_bias: torch.Tensor | None, k: int, *,
          norm_topk_prob: bool = True, scaling: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """x (T, H), router (H, E) -> (weights (T, k) fp32, experts (T, k) int64)."""
    scores = torch.sigmoid(torch.matmul(x, router.to(x.dtype)).float())
    choice = scores if expert_bias is None else scores + expert_bias.float()
    experts = torch.topk(choice, k, dim=-1).indices
    weights = torch.gather(scores, 1, experts)
    if norm_topk_prob:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-6)
    return weights * scaling, experts


def _count(stats: torch.Tensor | None, experts: torch.Tensor, num_experts: int) -> torch.Tensor:
    flat = experts.reshape(-1)  # bincount would read its length on the host
    counts = torch.zeros(num_experts, dtype=torch.int64, device=flat.device).scatter_add_(0, flat,
                                                                                         torch.ones_like(flat))
    if stats is not None:
        pairs = experts.numel()
        stats += torch.stack([torch.full_like(counts[0], pairs), (counts > 0).sum(), pairs - counts.sum()])
    return counts


def _swiglu(h: torch.Tensor) -> torch.Tensor:
    f = h.shape[-1] // 2
    return F.silu(h[..., :f]) * h[..., f:]


def experts_plain(x: torch.Tensor, w13: torch.Tensor, w2: torch.Tensor, weights: torch.Tensor,
                  experts: torch.Tensor, stats: torch.Tensor | None = None) -> torch.Tensor:
    """The loop over experts: x (T, H) -> (T, H) in x's dtype."""
    _count(stats, experts, w13.shape[0])
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(w13.shape[0]):
        token, slot = torch.nonzero(experts == e, as_tuple=True)
        if token.numel() == 0:
            continue
        y = torch.matmul(_swiglu(torch.matmul(x[token], w13[e].to(x.dtype))), w2[e].to(x.dtype))
        out.index_add_(0, token, y.float() * weights[token, slot, None])
    return out.to(x.dtype)


def experts_grouped(x: torch.Tensor, w13: torch.Tensor, w2: torch.Tensor, weights: torch.Tensor,
                    experts: torch.Tensor, stats: torch.Tensor | None = None) -> torch.Tensor:
    """The grouped route: static shapes, no host read.  x (T, H) -> (T, H)."""
    t, k = experts.shape
    flat = experts.reshape(-1)
    order = torch.argsort(flat, stable=True)  # pairs by expert, then by token
    offs = torch.cumsum(_count(stats, experts, w13.shape[0]), 0, dtype=torch.int32)
    h = torch._grouped_mm(x.index_select(0, order // k), w13, offs=offs)
    y = torch._grouped_mm(_swiglu(h), w2, offs=offs)
    y = torch.empty_like(y).index_copy_(0, order, y).view(t, k, -1)  # back to (token, slot) order
    return (y.float() * weights[..., None]).sum(dim=1).to(x.dtype)


def experts(x: torch.Tensor, w13: torch.Tensor, w2: torch.Tensor, weights: torch.Tensor, experts: torch.Tensor,
            stats: torch.Tensor | None = None) -> torch.Tensor:
    """The routed experts' weighted sum for each token: the plain version on
    CPU tensors, the grouped one on CUDA tensors."""
    fn = experts_grouped if x.is_cuda else experts_plain
    return fn(x, w13, w2, weights, experts, stats)
