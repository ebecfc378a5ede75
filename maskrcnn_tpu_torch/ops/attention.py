"""Multi-head attention with a relative-position bias: over a grid of
tokens with ViTDet's decomposed bias (`rel_pos_attention`), and over
Swin's windows with a dense per-head table and the shifted blocks' region
mask (`window_attention`).

`calls` counts the calls by route (`card`, `plain`), as `cuda_lib.launches`
counts kernels: a caller zeroes it (`reset_calls`), runs a forward and
sees whether anything took the plain route on the card. A CUDA graph's
capture counts its calls once and its replays count none.

ViTDet (Li et al., arXiv:2203.16527; Detectron2
`modeling/backbone/utils.py::add_decomposed_rel_pos`). For queries and
keys on one (h, w) grid, `d` channels a head:

    logit[(i, j), (kh, kw)] = scale * q[i, j] . k[kh, kw]
                              + rel_h[i, j, kh] + rel_w[i, j, kw]
    rel_h[i, j, kh] = sum_c q[i, j, c] * table_h[i - kh + h - 1, c]
    rel_w[i, j, kw] = sum_c q[i, j, c] * table_w[j - kw + w - 1, c]

with the unscaled q in the bias, then a softmax over the keys and the
probabilities times v. Nothing is masked: a window's padded tokens attend
and are attended to, as in Detectron2.

Two routes, by where and in what precision the call runs:

  * plain (the CPU, or float32 anywhere): the logits and the bias built
    explicitly, everything in float32;
  * card (CUDA, bfloat16): one `scaled_dot_product_attention` call on the
    exact augmented form q' = [scale * q, rel_h, rel_w],
    k' = [k, onehot(kh), onehot(kw)], whose dot products are the biased
    logits, with no (h w) x (h w) tensor. rel_h and rel_w are computed in
    bfloat16 (float32 sums) and rounded to it, as q' is; the kernel sums
    q'.k' and runs the softmax in float32. The route was chosen against
    the bias passed as an additive mask by a measurement on the card
    (`tools/probe_attention.py`, PERF.md).

Swin (Liu et al., arXiv:2103.14030; `Swin-Transformer-Object-Detection`
`mmdet/models/backbones/swin_transformer.py::WindowAttention`). For the
T = s * s tokens of one s x s window, query (i, j) and key (k, l):

    logit = scale * q . k + table[(i - k + s - 1) (2 s - 1)
                                  + (j - l + s - 1), head]
            [- 100 where a shifted block's region labels of the two differ]

then a softmax over the keys and the probabilities times v. Padded tokens
are not masked otherwise, as in the source. Two routes:

  * plain (the CPU, or float32 anywhere): the logits, the bias and the
    mask built explicitly, everything in float32;
  * card (CUDA, bfloat16): one `scaled_dot_product_attention` call over
    every window of every image, on SDPA's memory-efficient kernel, the
    bias and the mask folded into one additive bf16 mask, built once per
    parameter set and grid (`ParamCache`) and broadcast over the images:
    a plain block's (heads, T, T) over images and windows, a shifted
    block's (windows x heads, T, T) over images (its q, k, v then copied
    into that order). The kernel and the form were chosen by a
    measurement on the card (`tools/probe_attention.py`, PERF.md): the
    default backend (cuDNN) took ~1.8x as long, the augmented form and
    the explicit logits ~2-4x. Beyond the reference's float32: q, k, v,
    the output and the folded bias rounded to bfloat16 (the bias by at
    most 2^-9 of itself, the -100 exactly); the kernel sums q.k and runs
    the softmax in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from maskrcnn_tpu_torch.ops.common import (ParamCache, constant_cache,
                                           round_up, tracing)

calls = {"card": 0, "plain": 0}
# Swin's logit offset between tokens of different regions of a shifted
# window (the source's -100.0)
MASKED = -100.0


def reset_calls() -> None:
    for k in calls:
        calls[k] = 0


@constant_cache
def _offsets(size: int, device) -> torch.Tensor:
    """(size, size) int64: i - k + size - 1, the table row of query i and
    key k."""
    r = torch.arange(size, device=device)
    return r[:, None] - r[None, :] + (size - 1)


def rel_pos(table: torch.Tensor, size: int) -> torch.Tensor:
    """(2 size - 1, d) table -> (size, size, d): R[i, k] = table[i - k +
    size - 1]."""
    if table.shape[0] != 2 * size - 1:
        raise ValueError(f"a relative-position table for {size} positions "
                         f"has {2 * size - 1} rows, got {table.shape[0]}")
    return table[_offsets(size, table.device)]


def decomposed_bias(q: torch.Tensor, table_h: torch.Tensor,
                    table_w: torch.Tensor, hw: tuple[int, int]):
    """(n, heads, h w, d) queries -> rel_h (n, heads, h, w, h) and rel_w
    (n, heads, h, w, w), in q's dtype."""
    h, w = hw
    n, heads, _, d = q.shape
    rq = q.reshape(n, heads, h, w, d)
    rel_h = torch.einsum("nahwc,hkc->nahwk", rq,
                         rel_pos(table_h, h).to(q.dtype))
    rel_w = torch.einsum("nahwc,wkc->nahwk", rq,
                         rel_pos(table_w, w).to(q.dtype))
    return rel_h, rel_w


def _plain(q, k, v, table_h, table_w, hw, scale):
    h, w = hw
    q, k, v = q.float(), k.float(), v.float()
    n, heads, t, _ = q.shape
    rel_h, rel_w = decomposed_bias(q, table_h.float(), table_w.float(), hw)
    logits = (q * scale) @ k.transpose(-2, -1)
    logits = (logits.view(n, heads, h, w, h, w) + rel_h[..., :, None]
              + rel_w[..., None, :]).view(n, heads, t, t)
    return torch.softmax(logits, dim=-1) @ v


@constant_cache
def _key_onehots(h: int, w: int, width: int, dtype, device) -> torch.Tensor:
    """(h w, width): key (kh, kw)'s one-hot of kh in columns [0, h), of kw
    in [h, h + w), zeros after (the width padded to a multiple of 8)."""
    t = torch.arange(h * w, device=device)
    out = torch.zeros((h * w, width), dtype=dtype, device=device)
    out[t, t // w] = 1
    out[t, h + t % w] = 1
    return out


def _card(q, k, v, table_h, table_w, hw, scale):
    h, w = hw
    n, heads, t, d = q.shape
    rel_h, rel_w = decomposed_bias(q, table_h, table_w, hw)
    extra = round_up(d + h + w, 8) - d
    qa = torch.cat([q * scale, rel_h.reshape(n, heads, t, h),
                    rel_w.reshape(n, heads, t, w),
                    q.new_zeros((n, heads, t, extra - h - w))], -1)
    ka = torch.cat([k, _key_onehots(h, w, extra, k.dtype, k.device)
                    .expand(n, heads, t, extra)], -1)
    return F.scaled_dot_product_attention(qa, ka, v, scale=1.0)


def rel_pos_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      table_h: torch.Tensor, table_w: torch.Tensor,
                      hw: tuple[int, int], scale: float) -> torch.Tensor:
    """(n, heads, h w, d) q, k, v on one (h, w) grid (n: images times
    windows) and (2h - 1, d), (2w - 1, d) tables -> (n, heads, h w, d) in
    v's dtype."""
    if q.is_cuda and q.dtype == torch.bfloat16:
        calls["card"] += 1
        return _card(q, k, v, table_h, table_w, hw, scale)
    calls["plain"] += 1
    return _plain(q, k, v, table_h, table_w, hw, scale).to(v.dtype)


# --------------------------------------------------------------------------
# Swin: windows with a dense per-head table and a region mask
# --------------------------------------------------------------------------

@constant_cache
def relative_index(window: int, device) -> torch.Tensor:
    """(T, T) int64, T = window^2: the table row of query (i, j) and key
    (k, l) of one window, (i - k + window - 1) (2 window - 1) + (j - l +
    window - 1)."""
    r = torch.arange(window, device=device)
    i, j = r.repeat_interleave(window), r.repeat(window)
    side = 2 * window - 1
    return ((i[:, None] - i[None, :] + window - 1) * side
            + j[:, None] - j[None, :] + window - 1)


def window_bias(table: torch.Tensor, window: int) -> torch.Tensor:
    """((2 window - 1)^2, heads) table -> (heads, T, T) in its dtype."""
    if table.shape[0] != (2 * window - 1) ** 2:
        raise ValueError(f"a relative-position table for {window}x{window} "
                         f"windows has {(2 * window - 1) ** 2} rows, got "
                         f"{table.shape[0]}")
    return table[relative_index(window, table.device)].permute(2, 0, 1)


def region_mask(regions: torch.Tensor) -> torch.Tensor:
    """(windows, T) region labels -> (windows, T, T) float32: MASKED where
    the query's and the key's labels differ, else 0."""
    return (regions[:, :, None] != regions[:, None, :]).float() * MASKED


def _window_plain(q, k, v, table, window, scale, regions):
    q, k, v = q.float(), k.float(), v.float()
    logits = (q * scale) @ k.transpose(-2, -1) + window_bias(table.float(),
                                                             window)
    if regions is not None:
        logits = logits + region_mask(regions)[:, None]
    return torch.softmax(logits, dim=-1) @ v


_card_masks = ParamCache()


def _folded_mask(table, window, regions, dtype):
    """The card route's additive mask: a plain block's bias (1, heads, T,
    T), a shifted block's bias plus region mask (1, windows x heads, T,
    T), in `dtype`, a view of storage whose rows are padded to 64 columns
    (SDPA's memory-efficient kernel takes the mask without a copy only
    when its strides are aligned)."""
    bias = window_bias(table.float(), window)
    if regions is not None:
        bias = (bias[None] + region_mask(regions)[:, None]).flatten(0, 1)
    t = bias.shape[-1]
    store = bias.new_zeros((1, bias.shape[0], t, round_up(t, 64)),
                           dtype=dtype)
    store[0, :, :, :t] = bias
    return store[..., :t]


def _window_card(q, k, v, table, window, scale, regions):
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        return _window_sdpa(q, k, v, table, window, scale, regions)


def _window_sdpa(q, k, v, table, window, scale, regions):
    b, nw, heads, t, d = q.shape
    tensors = (table,) if regions is None else (table, regions)

    def build():
        return _folded_mask(table, window, regions, q.dtype)
    mask = build() if tracing() else _card_masks.get(tensors, build)
    # a plain block: images x windows as the batch, a view of q, k, v; a
    # shifted block: the images as the batch, windows x heads as the heads
    rows = (b * nw, heads) if regions is None else (b, nw * heads)
    o = F.scaled_dot_product_attention(
        q.reshape(*rows, t, d), k.reshape(*rows, t, d),
        v.reshape(*rows, t, d), attn_mask=mask, scale=scale)
    return o.view(b, nw, heads, t, d)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     table: torch.Tensor, window: int, scale: float,
                     regions: torch.Tensor | None = None) -> torch.Tensor:
    """(b, windows, heads, T, d) q, k, v of the window x window windows of
    b images (T = window^2), the block's ((2 window - 1)^2, heads) table
    and, in a shifted block, the windows' (windows, T) region labels
    (`ops/common.py::shift_regions`) -> (b, windows, heads, T, d) in v's
    dtype."""
    if q.is_cuda and q.dtype == torch.bfloat16:
        calls["card"] += 1
        return _window_card(q, k, v, table, window, scale, regions)
    calls["plain"] += 1
    return _window_plain(q, k, v, table, window, scale, regions).to(v.dtype)
