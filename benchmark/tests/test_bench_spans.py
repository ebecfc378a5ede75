"""`spans.py`'s reduction on made-up event lists (device work put down to
the span open at its launch, idle gaps to the spans open at their middle,
device user annotations left out) and on the port's own CPU spans."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import spans, trace


def _ev(name, start, end, device=False, id=0, ua=False):
    return SimpleNamespace(name=name, id=id, is_user_annotation=ua,
                           device_type="DeviceType.CUDA" if device
                           else "DeviceType.CPU",
                           time_range=SimpleNamespace(start=start, end=end))


def batch_events():
    return [
        _ev(trace.WINDOW, 0, 100, ua=True),
        _ev(trace.WINDOW, 5, 96, True, ua=True),
        _ev("detector.run_batch", 1, 90),
        _ev("mesh.copy_in", 2, 10),
        _ev("aten::copy_", 2.5, 5.5, id=7),
        _ev("cudaMemcpyAsync", 3, 5, id=101),
        _ev("forward", 12, 88),
        _ev("backbone_fpn", 13, 50),
        _ev("cudaLaunchKernel", 15, 16, id=102),
        _ev("cudaLaunchKernel", 20, 21, id=103),
        _ev("cudaLaunchKernel", 52, 53, id=104),
        _ev("rpn", 55, 80),
        _ev("cudaLaunchKernel", 56, 57, id=105),
        _ev("aten::add", 60, 61, id=103),     # an op id equal to a launch's
        _ev("Memcpy HtoD (Pageable -> Device)", 5, 12, True, id=101),
        _ev("conv_kernel", 16, 30, True, id=102),
        _ev("conv_kernel", 30, 40, True, id=103),
        _ev("elementwise_kernel", 53, 54, True, id=104),
        _ev("rpn_kernel", 57, 70, True, id=105),
        _ev("readback_kernel", 92, 96, True, id=999),
        # the profiler's device mirror of user annotations: not work
        _ev("backbone_fpn", 16, 40, True, ua=True),
        _ev("rpn", 45, 75, True, ua=True),
    ]


def test_spans_put_device_and_idle_time_down_to_stages():
    view = spans.SpanView(batch_events(), images=4)
    us = 1e-6
    assert view.window_s == pytest.approx(100 * us)
    assert view.host_s == pytest.approx({
        "detector.run_batch": 89 * us, "mesh.copy_in": 8 * us,
        "forward": 76 * us, "backbone_fpn": 37 * us, "rpn": 25 * us})
    assert dict(view.self_s) == pytest.approx({
        "detector.run_batch": 5 * us, "mesh.copy_in": 8 * us,
        "forward": 14 * us, "backbone_fpn": 37 * us, "rpn": 25 * us})
    assert view.device_s == pytest.approx({
        "mesh.copy_in": 7 * us, "backbone_fpn": 24 * us,
        "forward": 1 * us, "rpn": 13 * us})
    assert view.device_under_s["detector.run_batch"] == pytest.approx(45 * us)
    assert view.device_under_s["forward"] == pytest.approx(38 * us)
    assert view.unlinked_s == pytest.approx(4 * us)
    assert dict(view.idle_s) == pytest.approx({
        "mesh.copy_in": 5 * us, "backbone_fpn": 17 * us, "rpn": 3 * us,
        "forward": 22 * us, spans.NO_SPAN: 4 * us})
    assert view.idle_under_s["forward"] == pytest.approx(42 * us)
    r = view.readings()
    assert r == pytest.approx({
        "forward.host_ms_per_image": 76e-3 / 4,
        "forward.dispatch_idle": 42.0,
        "cover.forward_host": 1 - 14 / 76,
        "detector.copy_in_ms_per_image": 8e-3 / 4,
        "backbone_fpn.device_ms_per_image": 24e-3 / 4,
        "cover.run_batch_host": 1 - 5 / 89,
        "unstaged.run_batch_device": 1 / 45})


def test_device_user_annotations_move_nothing():
    """The device's user annotations (each spanning idle gaps) move
    nothing: the view reads as it does without them."""
    events = batch_events()
    plain = [e for e in events if not (e.is_user_annotation
                                       and e.name != trace.WINDOW)]
    a = spans.SpanView(events, images=4)
    b = spans.SpanView(plain, images=4)
    assert a.report() == b.report()


def test_stream_dispatch_to_sync():
    events = [
        _ev(trace.WINDOW, 0, 100, ua=True),
        _ev("stream.quantize", 0.5, 1),
        _ev("stream.dispatch", 1, 10), _ev("stream.dispatch", 11, 20),
        _ev("stream.sync", 21, 40), _ev("stream.dispatch", 41, 50),
        _ev("stream.sync", 51, 60)]
    view = spans.SpanView(events, images=12)
    assert [round(s * 1e6) for s in view.dispatch_to_sync_s] == [39, 29, 19]
    assert view.report()["stream.dispatch_ms"] == pytest.approx(
        {"first": 9e-3, "median": 9e-3, "max": 9e-3})
    assert view.readings() == pytest.approx({
        "stream.dispatch_ms_per_frame": 27e-3 / 12,
        "stream.sync_wait": 28.0,
        "stream.dispatch_to_sync_ms_median": 29e-3,
        "stream.dispatch_to_sync_ms_max": 39e-3})


def test_over_the_ports_cpu_spans():
    from torch.profiler import ProfilerActivity, profile, record_function

    from maskrcnn_tpu_torch.core.config import tiny_test_config
    from maskrcnn_tpu_torch.pipeline.detector import MaskRCNNDetector
    cfg = tiny_test_config().replace(compute_dtype="float32")
    det = MaskRCNNDetector.from_random(cfg, device="cpu")
    images = np.zeros((2, 128, 128, 3), np.uint8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW):
            det.run_batch(images)
    view = spans.SpanView(prof.events(), images=2)
    assert view.count["forward"] == 1 and view.count["backbone_fpn"] == 1
    r = view.readings()
    assert r["forward.host_ms_per_image"] > 0
    assert 0.5 < r["cover.forward_host"] <= 1.0
    assert 0.5 < r["cover.run_batch_host"] <= 1.0
    assert "unstaged.run_batch_device" not in r and view.device_s == {}
    # a window with no program spans (a program without them) reads nothing
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW):
            torch.ones(4).sum()
    assert spans.SpanView(prof.events(), images=1).readings() == {}
