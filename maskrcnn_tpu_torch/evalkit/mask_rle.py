"""COCO mask utilities: RLE encode/decode, IoU, polygon rasterization.
Port of `maskrcnn_tpu/evalkit/mask_rle.py` on its numpy paths (the JAX
package runs the same functions in its C++ library where that builds).

RLE convention matches COCO: column-major masks, runs alternating
background/foreground starting with background; the serialized form is
COCO's compressed LEB128-with-sign string.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


class RLE:
    __slots__ = ("h", "w", "counts")

    def __init__(self, h: int, w: int, counts: np.ndarray):
        self.h = int(h)
        self.w = int(w)
        self.counts = np.asarray(counts, np.uint32)

    def __repr__(self):
        return f"RLE({self.h}x{self.w}, {len(self.counts)} runs)"


def encode(mask: np.ndarray) -> RLE:
    """(h, w) binary mask -> RLE (column-major run counts)."""
    h, w = mask.shape
    col = np.asfortranarray(mask != 0).astype(np.uint8).reshape(-1, order="F")
    changes = np.flatnonzero(np.diff(col)) + 1
    edges = np.concatenate([[0], changes, [h * w]])
    counts = np.diff(edges)
    if col.size and col[0] == 1:
        counts = np.concatenate([[0], counts])
    return RLE(h, w, counts.astype(np.uint32))


def encode_region(region: np.ndarray, y0: int, x0: int,
                  h: int, w: int) -> RLE:
    """RLE of a full (h, w) canvas that is zero outside `region` pasted at
    (y0, x0): equal to `encode` of the materialized canvas, at O(region)
    cost (the canvas is never built or scanned)."""
    bh, bw = region.shape
    total = h * w
    if bh == 0 or bw == 0:
        return RLE(h, w, np.asarray([total], np.uint32))
    # A zero separator row below each column keeps every one-run inside a
    # single region column, so each maps to ONE contiguous canvas run.
    arr = np.zeros((bh + 1, bw), np.uint8)
    np.not_equal(region, 0, out=arr[:bh], casting="unsafe")
    col = arr.T.reshape(-1)
    changes = np.flatnonzero(col[1:] != col[:-1]) + 1
    edges = np.concatenate([[0], changes, [col.size]])
    first = 0 if col[0] == 1 else 1  # offset of the first ONE-run edge
    starts = edges[:-1][first::2]
    ends = edges[1:][first::2]
    if starts.size == 0:
        return RLE(h, w, np.asarray([total], np.uint32))
    # padded region index -> canvas column-major linear index
    c, r = np.divmod(starts, bh + 1)
    cs = (x0 + c) * h + (y0 + r)
    ce = cs + (ends - starts)
    # Merge runs contiguous in CANVAS space (only possible when the region
    # spans the full canvas height, so column c's run ends at the canvas
    # bottom and column c+1's starts at the top).
    if len(cs) > 1 and (cs[1:] == ce[:-1]).any():
        breaks = np.flatnonzero(np.concatenate([[True], cs[1:] != ce[:-1]]))
        lens = np.add.reduceat(ce - cs, breaks)
        cs = cs[breaks]
        ce = cs + lens
    counts = np.empty(2 * len(cs) + 1, np.int64)
    counts[0] = cs[0]
    counts[1::2] = ce - cs
    counts[2::2] = np.concatenate([cs[1:] - ce[:-1], [total - ce[-1]]])
    if counts[-1] == 0:  # encode omits a zero-length trailing zero run
        counts = counts[:-1]
    return RLE(h, w, counts.astype(np.uint32))


def decode(rle: RLE) -> np.ndarray:
    """RLE -> (h, w) uint8 mask."""
    vals = np.zeros(len(rle.counts), np.uint8)
    vals[1::2] = 1
    out = np.repeat(vals, rle.counts.astype(np.int64))
    out = np.resize(out, rle.h * rle.w)
    return out.reshape(rle.h, rle.w, order="F")


def area(rle: RLE) -> int:
    return int(rle.counts[1::2].astype(np.uint64).sum())


def iou_masks(dt: Sequence[RLE], gt: Sequence[RLE],
              iscrowd: Sequence[bool] | None = None) -> np.ndarray:
    """Pairwise IoU (len(dt), len(gt)). Crowd GT: inter / dt_area."""
    ndt, ngt = len(dt), len(gt)
    if ndt == 0 or ngt == 0:
        return np.zeros((ndt, ngt))
    crowd = np.asarray(
        iscrowd if iscrowd is not None else [0] * ngt, np.uint8)
    out = np.zeros((ndt, ngt))
    dm = [decode(r).astype(bool) for r in dt]
    gm = [decode(r).astype(bool) for r in gt]
    for i in range(ndt):
        for j in range(ngt):
            inter = np.logical_and(dm[i], gm[j]).sum()
            if crowd[j]:
                denom = dm[i].sum()
            else:
                denom = dm[i].sum() + gm[j].sum() - inter
            out[i, j] = inter / denom if denom > 0 else 0.0
    return out


def iou_boxes(dt: np.ndarray, gt: np.ndarray,
              iscrowd: Sequence[bool] | None = None) -> np.ndarray:
    """Pairwise IoU for (x, y, w, h) boxes (COCO layout)."""
    dt = np.asarray(dt, np.float64).reshape(-1, 4)
    gt = np.asarray(gt, np.float64).reshape(-1, 4)
    ndt, ngt = len(dt), len(gt)
    if ndt == 0 or ngt == 0:
        return np.zeros((ndt, ngt))
    crowd = np.asarray(
        iscrowd if iscrowd is not None else [0] * ngt, np.uint8)
    out = np.zeros((ndt, ngt))
    for i in range(ndt):
        ax, ay, aw, ah = dt[i]
        for j in range(ngt):
            bx, by, bw, bh = gt[j]
            ix = min(ax + aw, bx + bw) - max(ax, bx)
            iy = min(ay + ah, by + bh) - max(ay, by)
            if ix <= 0 or iy <= 0:
                continue
            inter = ix * iy
            denom = aw * ah if crowd[j] else aw * ah + bw * bh - inter
            out[i, j] = inter / denom if denom > 0 else 0.0
    return out


def from_polygons(polys: Sequence[Sequence[float]], h: int, w: int) -> RLE:
    """COCO polygon segmentation ([[x0,y0,x1,y1,...], ...]) -> merged RLE."""
    merged = np.zeros((h, w), np.uint8)
    for poly in polys:
        xy = np.asarray(poly, np.float64)
        if xy.size < 6:
            continue
        merged |= _poly_rasterize_np(xy.reshape(-1, 2), h, w)
    return encode(merged)


def _poly_rasterize_np(pts: np.ndarray, h: int, w: int) -> np.ndarray:
    """Even-odd scanline fill at pixel centers."""
    mask = np.zeros((h, w), np.uint8)
    xs, ys = pts[:, 0], pts[:, 1]
    n = len(pts)
    for r in range(h):
        py = r + 0.5
        xi = []
        for i in range(n):
            j = (i + 1) % n
            y0, y1 = ys[i], ys[j]
            if (y0 <= py < y1) or (y1 <= py < y0):
                t = (py - y0) / (y1 - y0)
                xi.append(xs[i] + t * (xs[j] - xs[i]))
        xi.sort()
        for k in range(0, len(xi) - 1, 2):
            c0 = max(int(np.ceil(xi[k] - 0.5)), 0)
            c1 = min(int(np.floor(xi[k + 1] - 0.5)), w - 1)
            if c1 >= c0:
                mask[r, c0:c1 + 1] = 1
    return mask


# --- COCO compressed string form (LEB128 with delta encoding) --------------

def to_coco_counts(rle: RLE) -> str:
    """Serialize to the COCO compressed counts string."""
    s = []
    counts = rle.counts.astype(np.int64)
    for i, x in enumerate(counts):
        if i > 2:
            x = x - counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (c & 0x10))
                        or (x == -1 and (c & 0x10)))
            if more:
                c |= 0x20
            s.append(chr(int(c) + 48))
    return "".join(s)


def from_coco_counts(s: str, h: int, w: int) -> RLE:
    """Parse the COCO compressed counts string."""
    counts = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return RLE(h, w, np.asarray(counts, np.uint32))


def from_coco_segmentation(seg, h: int, w: int) -> RLE:
    """Any COCO `segmentation` field (polygon list / uncompressed dict /
    compressed dict) -> RLE."""
    if isinstance(seg, list):
        return from_polygons(seg, h, w)
    if isinstance(seg, dict):
        hh, ww = seg["size"]
        c = seg["counts"]
        if isinstance(c, str):
            return from_coco_counts(c, hh, ww)
        return RLE(hh, ww, np.asarray(c, np.uint32))
    raise TypeError(f"unsupported segmentation type: {type(seg)}")
