"""The port's spans (`utils/profiling.stage`) on the CPU: the forward's
stages in order, nested in `forward`, nested in `detector.run_batch`
beside `mesh.copy_in`; the stream's dispatches and syncs with their
batch indices; no RecordFunction and no change to the outputs with the
profiler off."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from maskrcnn_tpu_torch.core.config import tiny_test_config
from maskrcnn_tpu_torch.pipeline import stream
from maskrcnn_tpu_torch.pipeline.detector import MaskRCNNDetector
from maskrcnn_tpu_torch.utils import profiling
from tests.torch_support import one_thread  # noqa: F401  (autouse)

BASE = dict(compute_dtype="float32", detection_score_threshold=0.0)
SPANS = {"detector.run_batch", "mesh.copy_in", "forward", "preprocess",
         "backbone_fpn", "rpn", "proposals", "roi_align_classifier",
         "classifier_head", "detection", "roi_align_mask", "mask_head",
         "roi_align_mask_fused", "paste", "stream.quantize",
         "stream.dispatch", "stream.sync"}
UNFUSED = ["preprocess", "backbone_fpn", "rpn", "proposals",
           "roi_align_classifier", "classifier_head", "detection",
           "roi_align_mask", "mask_head"]
FUSED = ["preprocess", "backbone_fpn", "rpn", "proposals",
         "roi_align_classifier", "detection", "roi_align_mask_fused"]
CASES = {"unfused": ({}, None, UNFUSED),
         "fused": ({"fuse_classifier_head": True, "fuse_mask_head": True},
                   None, FUSED),
         "paste": ({}, 64, UNFUSED + ["paste"])}


def detector(**overrides):
    cfg = tiny_test_config().replace(**BASE, **overrides)
    return MaskRCNNDetector.from_random(cfg, seed=3, device="cpu")


def images(n=2):
    rng = np.random.default_rng(5)
    return rng.integers(0, 256, (n, 128, 128, 3), dtype=np.uint8)


def spans(prof):
    """(name, enclosing span's name) of each span, in time order."""
    out = []
    for e in sorted((e for e in prof.events() if e.name in SPANS),
                    key=lambda e: e.time_range.start):
        parent = e.cpu_parent
        while parent is not None and parent.name not in SPANS:
            parent = parent.cpu_parent
        out.append((e.name, parent.name if parent is not None else None))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_forward_stages_nest_in_run_batch(case):
    overrides, paste_size, stages = CASES[case]
    det = detector(**overrides)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        det.run_batch(images(), paste_size=paste_size)
    assert spans(prof) == [("detector.run_batch", None),
                           ("mesh.copy_in", "detector.run_batch"),
                           ("forward", "detector.run_batch")] \
        + [(s, "forward") for s in stages]


@pytest.mark.parametrize("case", list(CASES))
def test_outputs_bit_equal_with_and_without_profiler(case):
    overrides, paste_size, _ = CASES[case]
    det = detector(**overrides)
    want = det.run_batch(images(), paste_size=paste_size)
    with profile(activities=[ProfilerActivity.CPU]):
        got = det.run_batch(images(), paste_size=paste_size)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("frames,micro_batch,sync_every,syncs", [
    (5, 2, 2, [1, 2]),           # 3 batches: a sync after the 2nd, the last
    (8, 2, 2, [1, 3, 3]),        # 4 batches: the last sync re-reads the 4th
    (3, 1, 0, [2]),              # no periodic syncs, only the last
])
def test_run_stream_spans_carry_batch_indices(frames, micro_batch,
                                              sync_every, syncs):
    det = detector()
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        stats = stream.run_stream(
            det, stream.synthetic_frames(frames, 128),
            micro_batch=micro_batch, sync_every=sync_every,
            latency_probes=1)
    batches = -(-frames // micro_batch)
    assert stats.frames == frames and stats.latency_probes == 1
    evs = sorted((e for e in prof.events() if e.name in SPANS),
                 key=lambda e: e.time_range.start)
    got = [(e.name, e.kwinputs.get("batch")) for e in evs
           if e.name in ("stream.dispatch", "stream.sync")]
    want = []
    for k in range(batches):
        want.append(("stream.dispatch", k))
        if sync_every and (k + 1) % sync_every == 0:
            want.append(("stream.sync", k))
    want.append(("stream.sync", batches - 1))
    assert got == want
    assert [i for n, i in got if n == "stream.sync"] == syncs
    # each frame's quantize and each batch's stack; the probe's run_batch
    # runs after the stream, outside every stream span
    assert sum(e.name == "stream.quantize" for e in evs) == frames + batches
    nested = [p for n, p in spans(prof) if n == "detector.run_batch"]
    assert nested == ["stream.dispatch"] * batches + [None]


def test_stage_enters_no_record_function_without_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a RecordFunction was opened")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert profiling.stage("a") is profiling.stage("b", batch=1)
    det = detector(fuse_classifier_head=True, fuse_mask_head=True)
    det.run_batch(images(), paste_size=64)
    stream.run_stream(det, stream.synthetic_frames(3, 128), micro_batch=2,
                      sync_every=1, latency_probes=0)
    timer = profiling.StageTimer()
    with timer.phase("inference"):
        pass
    assert timer.counts["inference"] == 1
    # the patch is what a span would call under a profiler
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="RecordFunction"):
            profiling.stage("a")


def test_stage_timer_phases_are_spans():
    timer = profiling.StageTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.phase("inference"):
            with timer.phase("results"):
                torch.ones(4).sum()
    names = {e.name: e for e in prof.events()}
    assert names["results"].cpu_parent is names["inference"]
    assert timer.counts == {"inference": 1, "results": 1}
