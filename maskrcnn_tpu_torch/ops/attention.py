"""Multi-head attention over a grid of tokens with ViTDet's decomposed
relative-position bias (Li et al., arXiv:2203.16527; Detectron2
`modeling/backbone/utils.py::add_decomposed_rel_pos`).

For queries and keys on one (h, w) grid, `d` channels a head:

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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from maskrcnn_tpu_torch.ops.common import constant_cache, round_up


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
        return _card(q, k, v, table_h, table_w, hw, scale)
    return _plain(q, k, v, table_h, table_w, hw, scale).to(v.dtype)
