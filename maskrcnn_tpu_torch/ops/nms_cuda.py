"""Greedy NMS keep flags: the CUDA kernel K1 (`csrc/nms.cu`) and its plain
PyTorch version. Replaces `maskrcnn_tpu/ops/nms_pallas.py::nms_keep_pallas`.

Contract (both versions): score-sorted (B, N, 4) float32 boxes and (B, N)
candidate flags -> (B, N) bool keep flags equal to the sequential greedy
selection (`IoU > t` as `inter > t * union`, zero-area boxes inert), exact
up to the `max_out`-th selection; flags after the tile where the walk
stopped read False.

The plain version walks the tiles as the kernel does: cross-suppression by
a compact buffer of the first `max_out` keepers, then the in-tile greedy as
the fixpoint of the suppression relation (the greedy solution is its unique
fixpoint, `maskrcnn_tpu/ops/nms.py`).
"""

from __future__ import annotations

import torch

from maskrcnn_tpu_torch.ops import cuda_lib
from maskrcnn_tpu_torch.ops.boxes import box_area, box_overlap_mask

TILE = 256  # the kernel's block width (boxes resolved per tile)


def nms_keep_plain(boxes: torch.Tensor, cand: torch.Tensor,
                   iou_threshold: float, max_out: int,
                   tile: int = TILE) -> torch.Tensor:
    b, n, _ = boxes.shape
    keep = torch.zeros((b, n), dtype=torch.bool, device=boxes.device)
    cand = cand & (box_area(boxes) > 0.0)
    for i in range(b):
        buf = boxes.new_zeros((0, 4))
        for start in range(0, n, tile):
            if buf.shape[0] >= max_out:
                break
            tb = boxes[i, start:start + tile]
            tc = cand[i, start:start + tile]
            if buf.shape[0]:
                tc = tc & ~box_overlap_mask(buf, tb, iou_threshold).any(0)
            over = box_overlap_mask(tb, tb, iou_threshold).triu(1)
            k = tc
            while True:
                nk = tc & ~(over & k[:, None]).any(0)
                if torch.equal(nk, k):
                    break
                k = nk
            keep[i, start:start + tile] = k
            buf = torch.cat([buf, tb[k][:max_out - buf.shape[0]]])
    return keep


def nms_keep_cuda(boxes: torch.Tensor, cand: torch.Tensor,
                  iou_threshold: float, max_out: int) -> torch.Tensor:
    b, n, _ = boxes.shape
    cuda_lib.require(boxes, "boxes", torch.float32, (b, n, 4))
    cuda_lib.require(cand, "cand", torch.bool, (b, n))
    lib = cuda_lib.load()
    if n > lib.mrt_nms_max_boxes(min(max_out, n)):
        raise ValueError(f"nms kernel holds at most "
                         f"{lib.mrt_nms_max_boxes(min(max_out, n))} boxes "
                         f"per image in shared memory, got {n}")
    keep = torch.empty((b, n), dtype=torch.bool, device=boxes.device)
    with torch.cuda.device(boxes.device):
        rc = lib.mrt_nms_keep(boxes.data_ptr(), cand.data_ptr(),
                              keep.data_ptr(), b, n, float(iou_threshold),
                              max_out, TILE, cuda_lib.stream_ptr(boxes))
    cuda_lib.check(rc, "nms")
    cuda_lib.launches["nms"] += 1
    return keep


def nms_keep(boxes: torch.Tensor, cand: torch.Tensor, iou_threshold: float,
             max_out: int) -> torch.Tensor:
    """Kernel on a CUDA tensor, plain version on a CPU tensor."""
    if boxes.is_cuda:
        return nms_keep_cuda(boxes.contiguous(), cand.contiguous(),
                             iou_threshold, max_out)
    return nms_keep_plain(boxes, cand, iou_threshold, max_out)
