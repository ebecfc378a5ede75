"""Faults planted in the timed path, to show that `correct` sees them.

    with faults.planted("no_suppression", cfg):
        ...   # the program runs broken until the block ends

Kinds (each breaks what the program produces, where it produces it):

  half_batch          every second image of the stream of images left out
                      (zero outputs, nothing valid)
  altered             each image's first detection moved by 0.1 in y
  no_suppression      K1 keeps the proposals' top candidates in score
                      order and suppresses nothing
  det_no_suppression  the detection NMS suppresses nothing
  over_suppression    both NMS calls at half their IoU threshold
  second_class        every detection takes the second-best class

`control.py` reads them on the card at a cell's own size (the upper
readings of the numbers that follow the program's discrete choices);
`benchmark/tests/test_bench_harness.py` plants them at tiny sizes.
"""

from __future__ import annotations

import contextlib

import torch

KINDS = ("half_batch", "altered", "no_suppression", "det_no_suppression",
         "over_suppression", "second_class")


@contextlib.contextmanager
def _patched(module, name, make):
    original = getattr(module, name)
    setattr(module, name, make(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def _outputs(kind):
    seen = [0]

    def make(original):
        def broken(self, images, paste_size=None):
            out = {k: v.clone() for k, v in original(
                self, images, paste_size=paste_size).items()}
            for i in range(out["detections"].shape[0]):
                if kind == "half_batch" and seen[0] % 2:
                    for k in out:
                        out[k][i] = 0
                elif kind == "altered":
                    out["detections"][i, 0, [0, 2]] += 0.1
                seen[0] += 1
            return out
        return broken
    return make


def _nms(kind, cfg):
    def make(original):
        def broken(boxes, cand, threshold, max_out):
            proposals = threshold == cfg.proposal_nms_threshold
            if (kind == "no_suppression" and proposals) or (
                    kind == "det_no_suppression" and not proposals):
                return cand & (torch.cumsum(cand.to(torch.int64), -1)
                               <= max_out)
            if kind == "over_suppression":
                threshold = threshold / 2
            return original(boxes, cand, threshold, max_out)
        return broken
    return make


def _second_class(original):
    def broken(rois, class_probs, class_deltas, **kw):
        p = class_probs.float()
        p = p.scatter(-1, p.argmax(-1, keepdim=True), -1.0)
        return original(rois, p, class_deltas, **kw)
    return broken


def planted(kind: str, cfg):
    """A context in which the program runs with the fault `kind`."""
    if kind in ("half_batch", "altered"):
        from maskrcnn_tpu_torch.pipeline.detector import MaskRCNNDetector
        return _patched(MaskRCNNDetector, "run_batch", _outputs(kind))
    if kind in ("no_suppression", "det_no_suppression", "over_suppression"):
        from maskrcnn_tpu_torch.ops import nms
        return _patched(nms, "nms_keep", _nms(kind, cfg))
    if kind == "second_class":
        from maskrcnn_tpu_torch.models import mask_rcnn
        return _patched(mask_rcnn, "refine_detections", _second_class)
    raise ValueError(f"unknown fault {kind!r}; one of {KINDS}")
