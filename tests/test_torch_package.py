"""Package hygiene of the PyTorch port, its CPU dispatch, and (marked `gpu`)
each CUDA kernel against its plain version on the card.

The `gpu` tests decide inside the test whether a card is there and skip
with a reason where there is none; run them on the card with
`pytest -m gpu tests/test_torch_*.py`."""

import os
import re
import subprocess
import sys

import numpy as np
import jax  # noqa: F401  (the port's tests import both frameworks)
import pytest
import torch

import maskrcnn_tpu_torch
from maskrcnn_tpu_torch.core.config import tiny_test_config
from maskrcnn_tpu_torch.models import heads as pt_heads
from maskrcnn_tpu_torch.models import mask_rcnn as pt_model
from maskrcnn_tpu_torch.ops import (bottleneck_cuda, cuda_lib, nms_cuda,
                                    roi_align, roi_align_cuda, stem_cuda)
from maskrcnn_tpu_torch.pipeline.detector import MaskRCNNDetector
from tests.test_torch_backbone import stage_params, stem_params
from tests.test_torch_ops import clustered_boxes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(maskrcnn_tpu_torch.__file__)


def _walk_package():
    """(dirpath, files) of the package's sources; `build/` holds what the
    kernel build writes, not sources."""
    for dirpath, dirnames, files in os.walk(PKG):
        dirnames[:] = [d for d in dirnames if d != "build"]
        yield dirpath, files


def _port_modules():
    mods = []
    for dirpath, files in _walk_package():
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                mods.append(rel[:-3].replace(os.sep, ".")
                            .removesuffix(".__init__"))
    return sorted(mods)


def test_import_loads_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            f"for m in {_port_modules()!r}:\n"
            "    __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'maskrcnn_tpu.')) or m == 'maskrcnn_tpu')\n"
            "print(len(bad), bad[:5])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "0", out.stdout


def test_sources_name_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|maskrcnn_tpu)\b", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, names in _walk_package():
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            src = f.read()
        assert not pat.search(src), path
        assert "__import__(\"jax" not in src, path


def test_entry_points_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_test_config()
    params = pt_model.init_mask_rcnn(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MaskRCNNDetector(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_model.forward(params, np.zeros((1, 128, 128, 3), np.float32), cfg)
    assert MaskRCNNDetector(cfg, params, device="cpu").device.type == "cpu"


def test_kernel_gates_stay_off_on_cpu():
    x = torch.zeros((1, 128, 128, 3))
    assert not stem_cuda.stem_supported(x, torch.bfloat16)
    blocks = [{"w1": torch.zeros(64, 64), "w3": torch.zeros(64, 256),
               "ws": torch.zeros(64, 256)}]
    assert not bottleneck_cuda.chain_supported(
        torch.zeros((1, 32, 32, 64)), torch.bfloat16, blocks)
    assert bottleneck_cuda.block_supported((1, 32, 32, 64), blocks[0])
    # the kernel masks ragged edge tiles itself; channel widths still gate
    assert bottleneck_cuda.block_supported((1, 30, 37, 64), blocks[0])
    assert not bottleneck_cuda.block_supported((1, 32, 32, 48), blocks[0])
    # the fused heads (K5, K6) take their plain versions on the CPU
    cfg = tiny_test_config().replace(fuse_classifier_head=True,
                                     fuse_mask_head=True,
                                     detection_score_threshold=0.0)
    params = pt_model.init_mask_rcnn(torch.Generator().manual_seed(0), cfg)
    cuda_lib.reset_launches()
    out = pt_model.forward(params, np.zeros((1, 128, 128, 3), np.float32),
                           cfg, device="cpu")
    assert out["masks"].shape == (1, cfg.max_detections, 28, 28)
    assert not any(cuda_lib.launches.values())


def test_fused_float32_config_raises_on_the_card():
    """A fused config in float32 is refused on a CUDA device before any
    work reaches it (the fused kernels take bf16), not run unfused."""
    cfg = tiny_test_config().replace(compute_dtype="float32",
                                     fuse_mask_head=True)
    params = pt_model.init_mask_rcnn(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="bfloat16 on the card"):
        pt_model.forward(params, np.zeros((1, 128, 128, 3), np.float32),
                         cfg, device="cuda")


def _nms_case(seed=0, b=2, n=600):
    rng = np.random.default_rng(seed)
    bx, vd = zip(*[clustered_boxes(rng, n) for _ in range(b)])
    return torch.from_numpy(np.stack(bx)), torch.from_numpy(np.stack(vd))


def _roi_case(seed=0, b=2, c=32, base=64, n=50, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    feats = [torch.from_numpy(rng.standard_normal(
        (b, base >> l, base >> l, c)).astype(np.float32)).to(dtype)
        for l in range(4)]
    yx1 = rng.uniform(0, 0.7, size=(b * n, 2))
    wh = rng.uniform(0.02, 0.6, size=(b * n, 2))
    rois = np.concatenate([yx1, np.minimum(yx1 + wh, 1.0)], -1)
    rois[::7] = 0.0
    ys, xs, level, valid = roi_align.prepare(
        torch.from_numpy(rois.astype(np.float32)),
        [(f.shape[1], f.shape[2]) for f in feats], (1024, 1024), 224.0, 7)
    return feats, ys, xs, level, valid, n


def _chain_case(seed=0, stage=2, cin=64, mid=64, cout=256, hw=(32, 32)):
    """A projection block, then two identity blocks."""
    rng = np.random.default_rng(seed)
    params = stage_params(rng, stage, cin, mid, cout, "abc", True)
    from maskrcnn_tpu_torch.io.weights import params_from_numpy
    blocks = bottleneck_cuda.fold_bottleneck_chain(
        params_from_numpy(params), stage, "abc")
    x = torch.from_numpy(rng.standard_normal((2, *hw, cin))
                         .astype(np.float32)).to(torch.bfloat16)
    return x, blocks


def _head_case(seed=0, b=2, n=20, crop=7, c=256, dtype=torch.float32):
    """Features, the pool's prepared positions, the packed head (K5 at
    pool 7, K6 at pool 14, 81 classes, BN statistics from the seed) and
    class ids 1..80."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    feats = [torch.from_numpy(rng.standard_normal(
        (b, 64 >> l, 64 >> l, c)).astype(np.float32)).to(dtype)
        for l in range(4)]
    yx1 = rng.uniform(0, 0.7, size=(b * n, 2))
    rois = np.concatenate([yx1, np.minimum(
        yx1 + rng.uniform(0.02, 0.6, size=(b * n, 2)), 1.0)], -1)
    rois[::9] = 0.0
    prep = roi_align.prepare(torch.from_numpy(rois.astype(np.float32)),
                             [(f.shape[1], f.shape[2]) for f in feats],
                             (1024, 1024), 224.0, crop)
    if crop == 7:
        params = pt_heads.init_classifier_head(gen, 81, c, 7, 1024)
    else:
        params = pt_heads.init_mask_head(gen, 81, c, c)
    for w in params.values():
        if "moving_variance" in w:
            k = w["gamma"].shape[0]
            w.update(gamma=torch.rand(k, generator=gen) + 0.5,
                     beta=torch.rand(k, generator=gen) * 0.4 - 0.2,
                     moving_mean=torch.rand(k, generator=gen) * 0.4 - 0.2,
                     moving_variance=torch.rand(k, generator=gen) + 0.5)
    packed = (roi_align_cuda.pack_classifier_head(params, 81, dtype)
              if crop == 7 else roi_align_cuda.pack_mask_head(params, dtype))
    ids = torch.from_numpy(rng.integers(1, 81, b * n).astype(np.int32))
    return feats, prep, n, packed, ids


def test_wrappers_take_plain_version_on_cpu():
    cuda_lib.reset_launches()
    boxes, valid = _nms_case()
    keep = nms_cuda.nms_keep(boxes, valid, 0.7, 50)
    assert keep.dtype == torch.bool and keep.shape == valid.shape
    feats, ys, xs, level, valid_r, n = _roi_case()
    out = roi_align_cuda.roi_align(feats, ys, xs, level, valid_r, n)
    assert out.shape == (ys.shape[0], 7, 7, 32)
    rng = np.random.default_rng(0)
    sp = {k: {w: torch.from_numpy(v) for w, v in d.items()}
          for k, d in stem_params(rng).items()}
    y = stem_cuda.apply_stem(sp, torch.zeros((1, 64, 64, 3)))
    assert y.shape == (1, 16, 16, 64) and y.dtype == torch.bfloat16
    x, blocks = _chain_case()
    z = bottleneck_cuda.fused_bottleneck_chain(x, blocks)
    assert z.shape == (2, 32, 32, 256) and z.dtype == torch.bfloat16
    feats, prep, n, head, _ = _head_case(c=32, n=6)
    h = roi_align_cuda.roi_classifier_head(feats, *prep, n, head)
    assert h.shape == (12, roi_align_cuda.HEAD_OUT) and h.dtype == torch.float32
    feats, prep, n, mask, ids = _head_case(c=32, n=6, crop=14)
    mk = roi_align_cuda.roi_mask_head(feats, *prep, n, mask, ids)
    assert mk.shape == (12, 28, 28) and mk.dtype == torch.float32
    assert set(cuda_lib.launches) == {"nms", "roi_align", "stem",
                                      "bottleneck", "roi_classifier_head",
                                      "roi_mask_head"}
    assert not any(cuda_lib.launches.values())


@pytest.mark.parametrize("m", [2000, 74, 1, 300])
def test_classifier_head_plan_covers_output_once(m):
    """K5's dense-1 plan: the tiles cover the (M, 1024) output exactly once
    in each K group, the groups partition the 196 K chunks of 12544, and a
    block's shared memory fits the H100's 232,448 bytes."""
    k1, n1 = 49 * 256, 1024
    plan = roi_align_cuda.classifier_head_plan(m, k1, n1)
    gx, gy, split = plan["grid"]
    rows = plan["rows"]
    assert rows >= m > rows - roi_align_cuda.HEAD_BM
    cover = np.zeros((rows, n1), np.int32)
    for bx in range(gx):
        for by in range(gy):
            cover[bx * 128:(bx + 1) * 128, by * 256:(by + 1) * 256] += 1
    assert (cover == 1).all()
    chunks = [c for lo, hi in plan["groups"] for c in range(lo, hi)]
    assert chunks == list(range(k1 // 64)) and split == len(plan["groups"])
    assert all(hi > lo for lo, hi in plan["groups"])
    assert plan["smem_bytes"] <= roi_align_cuda.SMEM_PER_BLOCK
    assert gx * gy * split <= 132 or split == 1
    if m == 2000:
        assert (gx, gy, split) == (16, 4, 2)


@pytest.mark.parametrize("shape,mid,cout,proj,ok", [
    ((2, 256, 256, 64), 64, 256, True, True),     # res2a at 1024^2
    ((2, 128, 128, 512), 128, 512, False, True),  # res3 b-d
    ((2, 30, 37, 64), 64, 256, True, True),       # ragged edge tiles
    ((1, 1, 1, 256), 64, 256, False, True),       # one pixel
    ((2, 32, 32, 64), 96, 256, True, False),      # mid width 96
    ((2, 32, 32, 48), 64, 256, True, False),      # Cin not a multiple of 64
    ((2, 32, 32, 64), 64, 256, False, False),     # identity, Cin != Cout
])
def test_block_supported_takes_any_height_and_width(shape, mid, cout, proj,
                                                    ok):
    blk = {"w1": torch.zeros(shape[-1], mid), "w3": torch.zeros(mid, cout)}
    if proj:
        blk["ws"] = torch.zeros(shape[-1], cout)
    assert bottleneck_cuda.block_supported(shape, blk) == ok


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    cuda_lib.load()
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_nms_kernel_matches_plain():
    dev = _card()
    boxes, valid = _nms_case(n=6000)
    for thr, max_out in ((0.7, 1000), (0.3, 100)):
        want = nms_cuda.nms_keep_plain(boxes, valid, thr, max_out)
        got = nms_cuda.nms_keep(boxes.to(dev), valid.to(dev), thr, max_out)
        assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_gpu_roi_align_kernel_matches_plain():
    dev = _card()
    for dtype in (torch.float32, torch.bfloat16):
        feats, ys, xs, level, valid, n = _roi_case(dtype=dtype)
        args = ([f.to(dev) for f in feats], ys.to(dev), xs.to(dev),
                level.to(dev), valid.to(dev), n)
        want = roi_align_cuda.roi_align_plain(*args).float()
        got = roi_align_cuda.roi_align(*args).float()
        # same float32 operations in the same order; one output rounding
        tol = 1e-6 if dtype == torch.float32 else 1e-2
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=tol * want.abs().max().item())


@pytest.mark.gpu
def test_gpu_stem_kernel_matches_plain():
    dev = _card()
    rng = np.random.default_rng(0)
    sp = {k: {w: torch.from_numpy(v).to(dev) for w, v in d.items()}
          for k, d in stem_params(rng).items()}
    w, bias = stem_cuda.fold_stem_weights(sp["conv1"], sp["bn_conv1"])
    images = torch.from_numpy(rng.uniform(-124, 132, (2, 128, 128, 3))
                              .astype(np.float32)).to(dev)
    want = stem_cuda.stem_plain(images, w, bias).float()
    got = stem_cuda.stem(images, w, bias).float()
    # float32 sums in another order, then one bf16 rounding: 1 bf16 ulp
    torch.testing.assert_close(got, want, rtol=2 ** -7,
                               atol=1e-3 * want.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("stage,cin,mid,cout,hw", [
    (2, 64, 64, 256, (32, 32)), (2, 64, 64, 256, (20, 37)),
    (3, 256, 128, 512, (16, 32)), (3, 256, 128, 512, (13, 21)),
    (2, 64, 64, 192, (9, 17))],
    ids=["mid64", "mid64-ragged", "mid128", "mid128-ragged", "cout192"])
def test_gpu_chain_kernel_matches_plain(stage, cin, mid, cout, hw):
    """Mid widths 64 and 128, a projection then identity blocks, edge tiles
    the 8 x 16 tile does not divide, and 64-column output chunks."""
    dev = _card()
    x, blocks = _chain_case(stage=stage, cin=cin, mid=mid, cout=cout, hw=hw)
    x = x.to(dev)
    blocks = [{k: v.to(dev) for k, v in b.items()} for b in blocks]
    want = bottleneck_cuda.chain_plain(x, blocks).float()
    got = bottleneck_cuda.fused_bottleneck_chain(x, blocks).float()
    # bf16 intermediates rounded at the same points, float32 sums in
    # another order: an ulp that later blocks carry on
    torch.testing.assert_close(got, want, rtol=0.02,
                               atol=0.01 * want.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("n", [20, 37])
def test_gpu_classifier_head_kernel_matches_plain(n):
    """Full widths (C = 256, 12544 -> 1024 -> 1024 -> 512), 2 x n ROIs (not
    a multiple of the 128-row tile), every ninth ROI invalid."""
    dev = _card()
    feats, prep, n, head, _ = _head_case(n=n, dtype=torch.bfloat16)
    assert not prep[3].all()
    args = ([f.to(dev) for f in feats], *[t.to(dev) for t in prep], n,
            {k: v.to(dev) for k, v in head.items()})
    want = roi_align_cuda.classifier_head_plain(*args)
    got = roi_align_cuda.roi_classifier_head(*args)
    # bf16 h1/h2 rounded at the same points after float32 sums in another
    # order: an ulp of h1 moves the outputs by far less than 2% of the max
    torch.testing.assert_close(got, want, rtol=0,
                               atol=0.02 * want.abs().max().item())


@pytest.mark.gpu
def test_gpu_mask_head_kernel_matches_plain():
    dev = _card()
    feats, prep, n, mask, ids = _head_case(crop=14, dtype=torch.bfloat16)
    args = ([f.to(dev) for f in feats], *[t.to(dev) for t in prep], n,
            {k: v.to(dev) for k, v in mask.items()}, ids.to(dev))
    want = roi_align_cuda.mask_head_plain(*args)
    got = roi_align_cuda.roi_mask_head(*args)
    # four bf16 activation roundings after float32 sums in another order,
    # through a sigmoid (slope <= 1/4)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-2)
