"""Small shared helpers for the ops modules."""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def round_up(x: int, m: int) -> int:
    """Smallest multiple of `m` that is >= `x`."""
    return ((x + m - 1) // m) * m


def graph_vjp(graph: Callable, tensors: Sequence[torch.Tensor],
              needs: Sequence[bool], grad_out: torch.Tensor) -> tuple:
    """The backward of a kernel that has no backward kernel: recompute the
    plain graph `graph(*tensors)` under autograd and return the gradient of
    `grad_out` against each tensor flagged in `needs` (None for the rest
    and for a tensor the graph does not reach). `grad_out` is cast to the
    graph's output dtype, as the JAX package's custom_vjp backwards cast
    their cotangent."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(bool(n))
                  for t, n in zip(tensors, needs)]
        out = graph(*inputs)
        wanted = [t for t, n in zip(inputs, needs) if n]
        got = iter(torch.autograd.grad(out, wanted, grad_out.to(out.dtype),
                                       allow_unused=True) if wanted else ())
        return tuple(next(got) if n else None for n in needs)
