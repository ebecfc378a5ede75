"""Mask-RCNN loss functions (Matterport formulation), port of
`maskrcnn_tpu/train/losses.py`: each a mean over its valid rows, with the
validity as a mask rather than a filter (static shapes).

With a process `group` (a data-parallel step, each rank a shard of the
batch) the head losses and the mean over images are each rank's share of
the global batch's mean: the local sum over the global count, so that the
ranks' losses add up to the single-device loss of the whole batch. The
RPN losses stay per-image means."""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F


def smooth_l1(diff: torch.Tensor) -> torch.Tensor:
    ad = diff.abs()
    return torch.where(ad < 1.0, 0.5 * ad * ad, ad - 0.5)


def _mean_over(x: torch.Tensor, mask: torch.Tensor,
               group=None) -> torch.Tensor:
    """The sum of `x` where `mask` over the count of `mask`, that count
    summed over the ranks of `group` when one is given."""
    m = mask.to(x.dtype)
    count = m.sum()
    if group is not None:
        count = count.detach().clone()
        dist.all_reduce(count, group=group)
    return (x * m).sum() / count.clamp_min(1.0)


def mean_over_images(per_image: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of per-image losses (B,) over the global batch (the
    batches of every rank of `group`)."""
    if group is None:
        return per_image.mean()
    return per_image.sum() / (per_image.shape[0]
                              * dist.get_world_size(group))


def rpn_class_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(A, 2) logits vs (A,) labels in {1 pos, -1 neg, 0 ignore}."""
    target = (labels == 1).to(torch.int64)
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, target[:, None])[:, 0]
    return _mean_over(nll, labels != 0)


def rpn_bbox_loss(pred: torch.Tensor, pos_deltas: torch.Tensor,
                  pos_idx: torch.Tensor,
                  pos_valid: torch.Tensor) -> torch.Tensor:
    """(A, 4) predicted deltas vs (K, 4) targets at the K sampled positive
    slots (`RPNTargets.pos_idx`)."""
    sel = pred[pos_idx].float()
    per = smooth_l1(sel - pos_deltas).sum(dim=-1)
    return _mean_over(per, pos_valid)


def mrcnn_class_loss(logits: torch.Tensor, class_ids: torch.Tensor,
                     valid: torch.Tensor, group=None) -> torch.Tensor:
    """(T, C) class logits vs (T,) targets (0 = background), valid rois."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, class_ids.to(torch.int64)[:, None])[:, 0]
    return _mean_over(nll, valid, group)


def mrcnn_bbox_loss(pred_deltas: torch.Tensor, target_deltas: torch.Tensor,
                    class_ids: torch.Tensor, group=None) -> torch.Tensor:
    """(T, C, 4) per-class predictions; loss at the target class, positives
    (class > 0) only."""
    ids = class_ids.to(torch.int64)[:, None, None].expand(-1, 1, 4)
    sel = pred_deltas.float().gather(1, ids)[:, 0]
    per = smooth_l1(sel - target_deltas).sum(dim=-1)
    return _mean_over(per, class_ids > 0, group)


def mrcnn_mask_loss(pred_masks: torch.Tensor, target_masks: torch.Tensor,
                    class_ids: torch.Tensor, group=None) -> torch.Tensor:
    """(T, m, m, C) sigmoid masks; binary cross-entropy at the target class
    channel, the probabilities clipped to [1e-7, 1 - 1e-7], positives
    only."""
    t, m = pred_masks.shape[0], pred_masks.shape[1]
    ids = class_ids.to(torch.int64)[:, None, None, None].expand(t, m, m, 1)
    sel = pred_masks.float().gather(-1, ids)[..., 0]
    eps = 1e-7
    sel = sel.clamp(eps, 1.0 - eps)
    bce = -(target_masks * torch.log(sel)
            + (1.0 - target_masks) * torch.log(1.0 - sel))
    return _mean_over(bce.mean(dim=(1, 2)), class_ids > 0, group)
