"""Greedy NMS keep flags: the CUDA kernel K1 (`csrc/nms.cu`) and its plain
PyTorch version. Replaces `maskrcnn_tpu/ops/nms_pallas.py::nms_keep_pallas`.

Contract (both versions): score-sorted (B, N, 4) float32 boxes and (B, N)
candidate flags -> (B, N) bool keep flags. Box i is selected iff it is a
candidate with positive area and no selected earlier box hits it (`IoU > t`
as `inter > t * union`); keep is True exactly for the first
`min(max_out, greedy count)` greedy selections.

Both versions run the same algorithm: the pairwise hit mask packed into
64-bit words (bit j of word w of row i: box 64 w + j comes after box i and
hits it), then a walk over the boxes in chunks of 64 that keeps, chunk by
chunk, the lowest candidate not yet removed and removes what its row hits.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from maskrcnn_tpu_torch.ops import cuda_lib
from maskrcnn_tpu_torch.ops.boxes import box_area, box_overlap_mask

CHUNK = 64  # boxes per mask word
# Boxes per image the kernel takes: its mask scratch is B x (N + 1) x
# ceil(N / 64) int64 words, 128 MB per image at this limit.
MAX_BOXES = 32768
_ROWS = 1024  # rows of the plain version's mask built at a time


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., K) bool -> (..., ceil(K / 64)) int64 words, bit j of word w
    from bits[..., 64 w + j]."""
    k = bits.shape[-1]
    words = -(-k // CHUNK)
    bits = F.pad(bits, (0, words * CHUNK - k))
    weights = torch.ones(CHUNK, dtype=torch.int64, device=bits.device) \
        << torch.arange(CHUNK, device=bits.device)
    return (bits.view(*bits.shape[:-1], words, CHUNK).to(torch.int64)
            * weights).sum(-1)


def pack_overlaps(boxes: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """(N, 4) boxes -> (N, ceil(N / 64)) int64 words: bit j of word w of row
    i is set iff 64 w + j > i and box_overlap_mask(box_i, box_64w+j)."""
    n = boxes.shape[0]
    col = torch.arange(n, device=boxes.device)
    out = [boxes.new_zeros((0, -(-n // CHUNK)), dtype=torch.int64)]
    for r0 in range(0, n, _ROWS):
        hit = box_overlap_mask(boxes[r0:r0 + _ROWS], boxes, iou_threshold)
        hit &= col[None, :] > col[r0:r0 + _ROWS, None]
        out.append(_pack_bits(hit))
    return torch.cat(out)


def _as_words(t: torch.Tensor) -> list:
    """int64 words -> Python ints in [0, 2^64)."""
    return t.cpu().numpy().view(np.uint64).tolist()


def nms_keep_plain(boxes: torch.Tensor, cand: torch.Tensor,
                   iou_threshold: float, max_out: int) -> torch.Tensor:
    b, n, _ = boxes.shape
    words = -(-n // CHUNK)
    cand_words = _pack_bits(cand & (box_area(boxes) > 0.0))
    keep = torch.zeros((b, words * CHUNK), dtype=torch.bool)
    for i in range(b):
        rows = _as_words(pack_overlaps(boxes[i], iou_threshold))
        avail_words = _as_words(cand_words[i])
        removed = [0] * words
        count = 0
        for c in range(words):
            avail = avail_words[c] & ~removed[c]
            while avail and count < max_out:
                j = (avail & -avail).bit_length() - 1
                keep[i, c * CHUNK + j] = True
                count += 1
                row = rows[c * CHUNK + j]
                avail &= ~((1 << j) | row[c])
                for w in range(c + 1, words):
                    removed[w] |= row[w]
            if count >= max_out:
                break
    return keep[:, :n].to(boxes.device)


def nms_keep_cuda(boxes: torch.Tensor, cand: torch.Tensor,
                  iou_threshold: float, max_out: int) -> torch.Tensor:
    b, n, _ = boxes.shape
    cuda_lib.require(boxes, "boxes", torch.float32, (b, n, 4))
    cuda_lib.require(cand, "cand", torch.bool, (b, n))
    if n > MAX_BOXES:
        raise ValueError(f"nms kernel takes at most {MAX_BOXES} boxes per "
                         f"image (mask scratch B x N x N/64 words), got {n}")
    mask = torch.empty((b, n + 1, -(-n // CHUNK)), dtype=torch.int64,
                       device=boxes.device)
    keep = torch.empty((b, n), dtype=torch.bool, device=boxes.device)
    lib = cuda_lib.load()
    with torch.cuda.device(boxes.device):
        rc = lib.mrt_nms_keep(boxes.data_ptr(), cand.data_ptr(),
                              mask.data_ptr(), keep.data_ptr(), b, n,
                              float(iou_threshold), max_out,
                              cuda_lib.stream_ptr(boxes))
    cuda_lib.check(rc, "nms")
    cuda_lib.launches["nms"] += 1
    return keep


@torch.library.custom_op("maskrcnn_tpu_torch::nms_keep", mutates_args=(),
                         device_types="cpu")
def _nms_keep_op(boxes: torch.Tensor, cand: torch.Tensor,
                 iou_threshold: float, max_out: int) -> torch.Tensor:
    return nms_keep_plain(boxes, cand, iou_threshold, max_out).contiguous()


_nms_keep_op.register_kernel("cuda")(nms_keep_cuda)


@_nms_keep_op.register_fake
def _(boxes, cand, iou_threshold, max_out):
    return cand.new_empty(cand.shape, dtype=torch.bool)


def nms_keep(boxes: torch.Tensor, cand: torch.Tensor, iou_threshold: float,
             max_out: int) -> torch.Tensor:
    """The op `maskrcnn_tpu_torch::nms_keep`: the kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    return _nms_keep_op(boxes.contiguous(), cand.contiguous(),
                        float(iou_threshold), int(max_out))
