"""Small shared helpers for the ops modules."""

from __future__ import annotations

import functools
import weakref
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import _get_current_dispatch_mode
from torch.utils.weak import WeakIdKeyDictionary


def round_up(x: int, m: int) -> int:
    """Smallest multiple of `m` that is >= `x`."""
    return ((x + m - 1) // m) * m


def tracing() -> bool:
    """True while torch traces rather than runs: `torch.export`,
    `torch.compile`, or under a dispatch mode such as fake tensors. A
    tensor built then is a placeholder of the trace."""
    return (torch.compiler.is_compiling()
            or _get_current_dispatch_mode() is not None)


def constant_cache(build: Callable) -> Callable:
    """`functools.lru_cache` for a builder of tensors the forward only
    reads, bypassed while `tracing()`: the trace gets a tensor of its own,
    as it did before the cache, and no later eager call gets the trace's
    placeholder back. `cache_clear` clears the cache."""
    cached = functools.lru_cache(maxsize=None)(build)

    @functools.wraps(build)
    def get(*args):
        return build(*args) if tracing() else cached(*args)

    get.cache_clear = cached.cache_clear
    return get


class ParamCache:
    """Values built from parameter tensors (a layer's prepared constants),
    kept while the first tensor lives: an entry goes with that tensor, and
    the cache keeps no parameter set alive. A value is built anew where
    one of its tensors was replaced or changed in place
    (`Tensor._version`). Callers bypass it while `tracing()`."""

    def __init__(self):
        # first tensor -> (each tensor's weak reference and version, value)
        self._entries = WeakIdKeyDictionary()

    def get(self, tensors: Sequence[torch.Tensor], build: Callable):
        entry = self._entries.get(tensors[0])
        if entry is not None and len(entry[0]) == len(tensors) and all(
                ref() is t and version == t._version
                for (ref, version), t in zip(entry[0], tensors)):
            return entry[1]
        value = build()
        self._entries[tensors[0]] = (tuple((weakref.ref(t), t._version)
                                           for t in tensors), value)
        return value


def device_constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """`torch.tensor(values, dtype=dtype, device=device)`, built once per
    (values, dtype, device) and shared after (`constant_cache`). A small
    tensor built from host numbers on every call is a host -> device copy
    and a sync each time, and neither may run while a CUDA graph captures
    the forward (`pipeline/stream.py`). `values` is a number or nested
    tuples of numbers; callers only read the tensor."""
    return _constant(values, dtype, torch.device(device))


@constant_cache
def _constant(values, dtype, device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


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


def window_partition(x: torch.Tensor, window: int, shift: int = 0):
    """A ViT's windowed layout (`models/vit.py`, `vit_epilogue_cuda`,
    `models/swin.py`): (B, H, W, C) -> (B * nh * nw, window, window, C),
    zero-padded on the bottom and right; also the padded (Hp, Wp). With
    `shift` (Swin's shifted windows) the padded map is rolled by
    (-shift, -shift) before it is cut."""
    b, h, w, c = x.shape
    ph, pw = -h % window, -w % window
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    if shift:
        x = torch.roll(x, (-shift, -shift), (1, 2))
    hp, wp = h + ph, w + pw
    x = x.view(b, hp // window, window, wp // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c), \
        (hp, wp)


def window_unpartition(x: torch.Tensor, window: int, padded, hw,
                       shift: int = 0):
    """`window_partition`'s inverse: the windows joined, rolled back by
    (shift, shift), the padding cropped."""
    (hp, wp), (h, w) = padded, hw
    b = x.shape[0] // (hp // window * wp // window)
    x = x.view(b, hp // window, wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    if shift:
        x = torch.roll(x, (shift, shift), (1, 2))
    return x[:, :h, :w]


@constant_cache
def shift_regions(padded: tuple[int, int], window: int, shift: int,
                  device) -> torch.Tensor:
    """(windows, window * window) int64: the region label of each token of
    a shifted block's windows (Swin, arXiv:2103.14030), in
    `window_partition(..., shift)`'s order. The rolled, padded (Hp, Wp)
    map is cut into rows [0, Hp - window), [Hp - window, Hp - shift),
    [Hp - shift, Hp) and columns alike, nine labels; two tokens of one
    window attend to each other unmasked only where their labels agree."""
    hp, wp = padded

    def bands(n):
        r = torch.arange(n, device=device)
        return (r >= n - window).long() + (r >= n - shift).long()

    labels = bands(hp)[:, None] * 3 + bands(wp)[None, :]
    labels = labels.view(hp // window, window, wp // window, window)
    return labels.permute(0, 2, 1, 3).reshape(-1, window * window)
