"""`run_stream`'s CUDA graph of the forward (`pipeline/stream.py::
ForwardGraph`) and the per-device constants that let the forward be
captured (`ops/common.py::device_constant`).

On the CPU: the stream takes no graph and counts its batches, the
constants equal the tensors the forward built before, an eager forward
after `torch.export` gets none of the trace's placeholders, and a second
forward builds no tensor from host data. On the card (marked `gpu`):
every graphed call's outputs equal the eager forward's on the same frames,
bit for bit, and each replay counts its kernels' launches. This file imports neither JAX nor the JAX package:

    python3 -m pytest --noconftest -m gpu tests/test_torch_stream_graph.py
"""

import numpy as np
import pytest
import torch

from maskrcnn_tpu_torch.core.anchors import anchor_spec
from maskrcnn_tpu_torch.core.config import tiny_test_config
from maskrcnn_tpu_torch.models import mask_rcnn as M
from maskrcnn_tpu_torch.io.export import export_program, load_program
from maskrcnn_tpu_torch.ops import common, cuda_lib
from maskrcnn_tpu_torch.ops.common import device_constant
from maskrcnn_tpu_torch.pipeline import stream
from maskrcnn_tpu_torch.pipeline.detector import MaskRCNNDetector
from tests.torch_support import one_thread  # noqa: F401  (autouse)

FUSED = dict(fuse_classifier_head=True, fuse_mask_head=True,
             detection_score_threshold=0.0)


def test_run_stream_on_cpu_takes_no_graph():
    det = MaskRCNNDetector.from_random(tiny_test_config().replace(**FUSED),
                                       seed=0, device="cpu")
    stats = stream.run_stream(det, stream.synthetic_frames(5, 128, seed=2),
                              micro_batch=2, paste_size=32,
                              latency_probes=1, sync_every=2)
    assert stats.frames == 5 and stats.batches == 3
    assert stats.graphed_batches == 0 and stats.captures == 0
    assert det.graphs == {}


_CFG = tiny_test_config()
_SPEC = anchor_spec(_CFG)


@pytest.mark.parametrize("values,dtype", [
    (tuple(_CFG.mean_pixel), torch.float32),
    (tuple(map(float, _CFG.bbox_std_dev)), torch.float32),
    (128.0 * 128.0, torch.float32),
    (tuple(lv[0] for lv in _SPEC[0]), torch.int64),
    (tuple(tuple(map(tuple, lv[4])) for lv in _SPEC[0]), torch.float32),
], ids=["mean_pixel", "bbox_std_dev", "image_area", "anchor_starts",
        "anchor_hw"])
def test_device_constant_equals_the_tensor_and_is_built_once(values, dtype):
    got = device_constant(values, dtype, "cpu")
    want = torch.tensor(values, dtype=dtype)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert device_constant(values, dtype, torch.device("cpu")) is got


@pytest.mark.parametrize("analytic_anchors", [True, False])
def test_eager_forward_after_export_gets_no_traced_constant(tmp_path,
                                                            analytic_anchors):
    """The constants are first built while `torch.export` traces the
    forward: the trace gets its own, and the eager forward that follows in
    the same process builds real ones and equals the exported program."""
    cfg = tiny_test_config().replace(analytic_anchors=analytic_anchors)
    params = M.init_mask_rcnn(torch.Generator().manual_seed(1), cfg)
    common._constant.cache_clear()
    M.anchor_table.cache_clear()
    export_program(params, cfg, str(tmp_path), device="cpu")
    images = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 255, (1, 128, 128, 3)).astype(np.float32))
    want = M.forward(params, images, cfg, device="cpu")
    with torch.no_grad():
        got = load_program(str(tmp_path))(images)
    assert sorted(got) == ["detections", "masks", "valid"]
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
    assert int(want["valid"].sum()) > 0


@pytest.mark.parametrize("overrides", [
    FUSED,
    dict(analytic_anchors=False),
    dict(FUSED, architecture="mobilenetv2"),
], ids=["fused_heads", "anchor_table", "mobilenetv2"])
def test_second_forward_builds_no_tensor_from_host_data(monkeypatch,
                                                        overrides):
    """A CUDA graph cannot capture a host -> device copy: after the first
    forward, the forward makes no tensor from host numbers or arrays, and
    its outputs stay the same."""
    cfg = tiny_test_config().replace(**overrides)
    params = M.init_mask_rcnn(torch.Generator().manual_seed(1), cfg)
    images = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 128, 128, 3), dtype=np.uint8))
    first = M.forward(params, images, cfg, device="cpu", paste_size=32)

    def refuse(*args, **kwargs):
        raise AssertionError("the forward built a tensor from host data")

    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "from_numpy", refuse)
    second = M.forward(params, images, cfg, device="cpu", paste_size=32)
    assert sorted(second) == sorted(first)
    for k, v in first.items():
        assert torch.equal(second[k], v), k


@pytest.mark.gpu
@pytest.mark.parametrize("overrides", [
    dict(FUSED, architecture="mobilenetv2"),
    dict(detection_score_threshold=0.0),
], ids=["mobilenetv2_fused_heads", "resnet50_k1_k4"])
def test_gpu_stream_graph_equals_eager_forward(overrides):
    """Micro-batch 4 with `paste_size` over 3 different full batches and a
    partial one, two calls in flight: every graphed call's outputs, all
    kept to the end, equal `run_batch`'s on the same frames (a stale input
    or outputs aliased between calls would not); one capture serves the
    call and a second call on the detector."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs have no CPU mode)")
    cfg = tiny_test_config().replace(**overrides)
    det = MaskRCNNDetector.from_random(cfg, seed=4, device="cuda")
    frames = list(stream.synthetic_frames(14, 128, seed=5))
    bounds = [(0, 4), (4, 8), (8, 12), (12, 14)]
    cuda_lib.reset_launches()
    det.run_batch(np.stack(frames[:4]), paste_size=128)
    per_forward = dict(cuda_lib.launches)
    assert any(per_forward.values())

    def drive():
        seen = {}
        cuda_lib.reset_launches()
        stats = stream.run_stream(
            det, frames, on_result=lambda i, out: seen.update({i: out}),
            micro_batch=4, paste_size=128, latency_probes=2, sync_every=2)
        torch.cuda.synchronize()
        return stats, seen

    def launched_forwards(stats):
        # a capture runs the forward once eagerly first, and records the
        # launches of the replays without running them
        forwards = stats.batches + stats.latency_probes + stats.captures
        return {k: n * forwards for k, n in per_forward.items()}

    stats, seen = drive()
    assert (stats.frames, stats.batches) == (14, 4)
    assert stats.graphed_batches == 3 and stats.captures == 1
    assert cuda_lib.launches == launched_forwards(stats)
    assert len(det.graphs) == 1
    assert sorted(seen) == [start for start, _ in bounds]
    assert not torch.equal(seen[0]["detections"], seen[4]["detections"])
    for start, stop in bounds:
        want = det.run_batch(np.stack(frames[start:stop]), paste_size=128)
        assert sorted(seen[start]) == sorted(want)
        for k, v in want.items():
            assert torch.equal(seen[start][k], v), (start, k)

    again, seen2 = drive()
    assert again.graphed_batches == 3 and again.captures == 0
    assert cuda_lib.launches == launched_forwards(again)
    assert len(det.graphs) == 1
    for start, _ in bounds:
        for k, v in seen[start].items():
            assert torch.equal(seen2[start][k], v), (start, k)
