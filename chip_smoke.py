"""Smoke run of the PyTorch port on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py [--seed 0] [--batch 2]

Phases, each printing one JSON line, any failure ends the run non-zero:

  device   the card (`torch.cuda.get_device_name`, nvidia-smi name and
           power limit); no card -> exit 2 before anything else
  build    nvcc builds the four kernels from `maskrcnn_tpu_torch/csrc`
  K1..K4   each kernel against its plain PyTorch version on the card at the
           main path's shapes (R101-FPN @ 1024^2, batch --batch), with its
           time, the plain version's time, the least time the card could
           take (`bound_ms`) and, where one PyTorch call computes the same
           function, that call's time (`library_ms`, never used by the port)
  small    the detector forward on the card against the same forward on the
           CPU (plain path), tiny config in float32
  e2e      `MaskRCNNDetector.detect_images` at R101-FPN @ 1024^2, 81 classes,
           bf16, random weights from --seed with BN statistics drawn from the
           seed, over 4 letterboxed images of mixed sizes, batch 2: once at
           the default thresholds, once with the score threshold at 0 so
           100 detections per image reach the mask branch (the main path:
           the launch counts are zeroed just before it and read just after)

then a `kernels` line, the nvidia-smi line, and last
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16
# tensor-core FLOP/s, float32 FLOP/s outside the tensor cores.
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `reps` back-to-back calls (CUDA events
    after warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float, peak: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def live_bn(params: dict, gen: torch.Generator, gamma=(0.3, 0.8)) -> None:
    """Draw every BN's statistics from the seed (random init zeroes each
    block's last gamma, which would leave the residual branches dead)."""
    for w in params.values():
        if "moving_variance" in w:
            c = w["gamma"].shape[0]
            u = lambda lo, hi: torch.rand(c, generator=gen) * (hi - lo) + lo
            w["gamma"], w["beta"] = u(*gamma), u(-0.2, 0.2)
            w["moving_mean"], w["moving_variance"] = u(-0.2, 0.2), u(0.5, 2.0)


def record(name, route, source, replaces, ms, plain_ms, err, tol, bnd,
           library_ms, extra=None, ok=None):
    """One kernel's row; fails unless ok (default: err <= tol)."""
    t_bound, by = bnd
    row = {"name": name, "route": route, "source": source,
           "replaces": replaces, "launches": None, "max_abs_err": err,
           "tol": tol, "ms": ms, "plain_ms": plain_ms, "bound_ms": t_bound,
           "bound_by": by, "library_ms": library_ms}
    row.update(extra or {})
    emit({"phase": name, **row})
    if not (err <= tol if ok is None else ok):
        raise AssertionError(f"{name}: max abs err {err} over tol {tol}")
    return row


# --------------------------------------------------------------------------
# K1 NMS
# --------------------------------------------------------------------------

def clustered_boxes(rng, b, n, classes=0):
    centers = rng.uniform(0.05, 0.95, size=(b, max(n // 12, 1), 2))
    pick = np.take_along_axis(
        centers, rng.integers(0, centers.shape[1], (b, n))[..., None], 1)
    half = rng.uniform(0.01, 0.12, size=(b, n, 2))
    ctr = pick + rng.normal(0, 0.02, size=(b, n, 2))
    boxes = np.clip(np.concatenate([ctr - half, ctr + half], -1), 0, 1)
    if classes:
        boxes = boxes + 2.0 * rng.integers(1, classes, (b, n, 1))
    return torch.from_numpy(boxes.astype(np.float32))


def nms_work(boxes, keep, cand, t, max_out):
    """IoU tests a sequential greedy makes on this data: each candidate up
    to the stop tests the keepers before it until the first that hits it."""
    from maskrcnn_tpu_torch.ops.boxes import box_overlap_mask
    tests = 0
    for i in range(boxes.shape[0]):
        kidx = torch.nonzero(keep[i]).flatten()[:max_out]
        stop = (int(kidx[-1]) + 1 if kidx.numel() == max_out
                else boxes.shape[1])
        hits = box_overlap_mask(boxes[i, kidx], boxes[i, :stop], t)
        before = kidx[:, None] < torch.arange(stop, device=boxes.device)
        hits = hits & before
        first = torch.where(hits.any(0), hits.to(torch.int8).argmax(0) + 1,
                            before.sum(0))
        tests += int(first[cand[i, :stop]].sum())
    return tests


def check_nms(dev, rng, batch):
    from maskrcnn_tpu_torch.ops import nms_cuda
    from maskrcnn_tpu_torch.ops.nms import _compact
    rows = []
    for stage, n, t, max_out, classes in (("proposals", 6000, 0.7, 1000, 0),
                                          ("detections", 1000, 0.3, 100, 8)):
        boxes = clustered_boxes(rng, batch, n, classes).to(dev)
        cand = torch.ones((batch, n), dtype=torch.bool, device=dev)
        want = nms_cuda.nms_keep_plain(boxes, cand, t, max_out)
        got = nms_cuda.nms_keep(boxes, cand, t, max_out)
        wi, wv = _compact(want, n, max_out)
        gi, gv = _compact(got, n, max_out)
        idx_err = float((wi - gi).abs().max()) if torch.equal(wv, gv) \
            else float(n)
        ms = cuda_ms(lambda: nms_cuda.nms_keep(boxes, cand, t, max_out), 50)
        plain_ms = cuda_ms(
            lambda: nms_cuda.nms_keep_plain(boxes, cand, t, max_out), 2, 1)
        tests = nms_work(boxes, want, cand, t, max_out)
        rows.append(record(
            f"K1_nms_{stage}", "cuda", "maskrcnn_tpu_torch/csrc/nms.cu",
            "maskrcnn_tpu/ops/nms_pallas.py:184", ms, plain_ms,
            idx_err, 0.0,
            bound(nbytes(boxes, cand) + cand.numel(), 20.0 * tests,
                  F32_FLOPS), None,
            {"shape": [batch, n], "iou": t, "max_out": max_out,
             "kept": int(gv.sum()), "iou_tests": tests}))
    return rows


# --------------------------------------------------------------------------
# K2 ROIAlign
# --------------------------------------------------------------------------

def spread_rois(rng, b, n):
    """Valid ROIs over all four levels at 1024^2, a few zero rows."""
    side = np.exp(rng.uniform(np.log(0.02), np.log(0.9), size=(b, n, 1)))
    aspect = np.exp(rng.uniform(-0.7, 0.7, size=(b, n, 1)))
    hw = np.concatenate([side * aspect, side / aspect], -1).clip(0.01, 1)
    yx1 = rng.uniform(0, 1, size=(b, n, 2)) * (1 - hw)
    rois = np.concatenate([yx1, yx1 + hw], -1)
    rois[:, -max(n // 20, 1):] = 0.0
    return torch.from_numpy(rois.astype(np.float32))


def check_roi_align(dev, rng, batch, pyramid):
    from maskrcnn_tpu_torch.ops import roi_align as ra
    from maskrcnn_tpu_torch.ops import roi_align_cuda
    rows = []
    hw = [(f.shape[1], f.shape[2]) for f in pyramid]
    for crop, n in ((7, 1000), (14, 100)):
        rois = spread_rois(rng, batch, n).to(dev)
        ys, xs, level, valid = ra.prepare(rois.reshape(-1, 4), hw,
                                          (1024, 1024), 224.0, crop)
        args = (pyramid, ys, xs, level, valid, n)
        want = roi_align_cuda.roi_align_plain(*args)
        got = roi_align_cuda.roi_align(*args)
        err = (got.float() - want.float()).abs().max().item()
        # plain and kernel do the same float32 operations in the same
        # order; allow one bf16 ulp of the largest output
        tol = 2.0 ** -8 * want.float().abs().max().item()
        ms = cuda_ms(lambda: roi_align_cuda.roi_align(*args), 20)
        plain_ms = cuda_ms(lambda: roi_align_cuda.roi_align_plain(*args), 3)
        cells = distinct_cells(ys, xs, level, valid, n, hw)
        c = pyramid[0].shape[-1]
        moved = (cells * c * pyramid[0].element_size() + nbytes(got)
                 + nbytes(ys, xs, level, valid))
        levels = torch.bincount(level[valid].long(), minlength=4).tolist()
        rows.append(record(
            f"K2_roi_align_pool{crop}", "cuda",
            "maskrcnn_tpu_torch/csrc/roi_align.cu",
            "maskrcnn_tpu/ops/roi_align_pallas.py:716", ms, plain_ms, err,
            tol, bound(moved, 10.0 * got.numel(), F32_FLOPS), None,
            {"rois": [batch, n], "rois_per_level": levels,
             "distinct_cells": cells,
             "plain_max_abs": want.float().abs().max().item()}))
    return rows


def distinct_cells(ys, xs, level, valid, n, hw):
    """Pyramid cells (image, level, y, x) the bilinear corners touch."""
    keys = []
    img = torch.arange(ys.shape[0], device=ys.device) // n
    for li, (fh, fw) in enumerate(hw):
        sel = (level == li) & valid
        if not sel.any():
            continue
        y, x = ys[sel], xs[sel]
        ok = ((y >= 0) & (y <= fh - 1))[:, :, None] & \
             ((x >= 0) & (x <= fw - 1))[:, None, :]
        y0 = y.floor().clamp(0, fh - 1).long()
        x0 = x.floor().clamp(0, fw - 1).long()
        for yy in (y0, (y0 + 1).clamp(max=fh - 1)):
            for xx in (x0, (x0 + 1).clamp(max=fw - 1)):
                k = ((img[sel][:, None, None] * 4 + li) * fh
                     + yy[:, :, None]) * fw + xx[:, None, :]
                keys.append(k[ok])
    return int(torch.unique(torch.cat(keys)).numel()) if keys else 0


# --------------------------------------------------------------------------
# K3 stem, K4 bottleneck chains
# --------------------------------------------------------------------------

def check_stem(dev, rng, batch, params):
    from maskrcnn_tpu_torch.ops import stem_cuda
    images = torch.from_numpy(rng.uniform(-124, 132, (batch, 1024, 1024, 3))
                              .astype(np.float32)).to(dev)
    w, bias = stem_cuda.fold_stem_weights(params["conv1"], params["bn_conv1"])
    want = stem_cuda.stem_plain(images, w, bias).float()
    got = stem_cuda.stem(images, w, bias).float()
    err = (got - want).abs()
    # float32 sums in another order before one bf16 rounding: at most one
    # bf16 ulp of each value (2^-8 relative), plus slack at zero
    tol_each = 2.0 ** -8 * want.abs() + 1e-3 * want.abs().max()
    bad = int((err > tol_each).sum())
    ms = cuda_ms(lambda: stem_cuda.stem(images, w, bias), 20)
    plain_ms = cuda_ms(lambda: stem_cuda.stem_plain(images, w, bias), 3)
    wc = w.permute(3, 2, 0, 1).contiguous()
    bc = bias.to(torch.bfloat16)

    def library():
        y = F.conv2d(images.permute(0, 3, 1, 2).to(torch.bfloat16), wc, bc,
                     stride=2, padding=3)
        return F.max_pool2d(F.pad(torch.relu(y), (0, 1, 0, 1)), 3, 2)

    library_ms = cuda_ms(library, 20)
    flops = 2.0 * batch * 512 * 512 * 64 * 147
    return [record("K3_stem", "cuda", "maskrcnn_tpu_torch/csrc/stem.cu",
                   "maskrcnn_tpu/ops/stem_pallas.py:197", ms, plain_ms,
                   err.max().item(), "2^-8*|plain| + 1e-3*max|plain| each",
                   bound(nbytes(images, w, bias) + got.numel() * 2, flops,
                         BF16_FLOPS), library_ms,
                   {"shape": list(images.shape), "elements_over_tol": bad,
                    "plain_max_abs": want.abs().max().item()},
                   ok=bad == 0)]


def chain_flops(x_shape, blocks) -> float:
    b, h, w, _ = x_shape
    total = 0.0
    for blk in blocks:
        cin, m = blk["w1"].shape
        cout = blk["w3"].shape[1]
        macs = cin * m + 9 * m * m + m * cout
        if "ws" in blk:
            macs += cin * cout
        total += 2.0 * b * h * w * macs
    return total


def check_chains(dev, rng, batch, params):
    from maskrcnn_tpu_torch.ops import bottleneck_cuda as bc
    rows = []
    for stage, letters, hw, cin in ((2, "abc", 256, 64), (3, "bcd", 128, 512)):
        blocks = bc.fold_bottleneck_chain(params, stage, letters)
        x = torch.from_numpy(rng.standard_normal((batch, hw, hw, cin))
                             .astype(np.float32)).to(dev).to(torch.bfloat16)
        want = bc.chain_plain(x, blocks).float()
        got = bc.fused_bottleneck_chain(x, blocks).float()
        err = (got - want).abs()
        # bf16 intermediates rounded at the same points, float32 sums in
        # another order: an ulp that later blocks carry on
        tol_each = 0.02 * want.abs() + 0.01 * want.abs().max()
        bad = int((err > tol_each).sum())
        ms = cuda_ms(lambda: bc.fused_bottleneck_chain(x, blocks), 10)
        plain_ms = cuda_ms(lambda: bc.chain_plain(x, blocks), 2, 1)
        lib = [(blk["w1"].t()[:, :, None, None].contiguous(), blk["b1"],
                blk["w2"].reshape(3, 3, *blk["w2"].shape[1:])
                .permute(3, 2, 0, 1).contiguous(), blk["b2"],
                blk["w3"].t()[:, :, None, None].contiguous(), blk["b3"],
                blk["ws"].t()[:, :, None, None].contiguous()
                if "ws" in blk else None, blk.get("bs")) for blk in blocks]

        def library():
            y = x.permute(0, 3, 1, 2)
            for w1, b1, w2, b2, w3, b3, ws, bs in lib:
                t = torch.relu(F.conv2d(y, w1, b1.to(y.dtype)))
                t = torch.relu(F.conv2d(t, w2, b2.to(y.dtype), padding=1))
                t = F.conv2d(t, w3, b3.to(y.dtype))
                s = F.conv2d(y, ws, bs.to(y.dtype)) if ws is not None else y
                y = torch.relu(t + s)
            return y

        library_ms = cuda_ms(library, 10)
        wbytes = sum(nbytes(*blk.values()) for blk in blocks)
        rows.append(record(
            f"K4_chain_res{stage}{letters}", "cuda",
            "maskrcnn_tpu_torch/csrc/bottleneck.cu",
            "maskrcnn_tpu/ops/bottleneck_pallas.py:213", ms, plain_ms,
            err.max().item(), "0.02*|plain| + 0.01*max|plain| each",
            bound(nbytes(x) + got.numel() * 2 + wbytes,
                  chain_flops(x.shape, blocks), BF16_FLOPS),
            library_ms,
            {"shape": list(x.shape), "cout": blocks[-1]["w3"].shape[1],
             "elements_over_tol": bad, "kernel_launches_per_chain": 3,
             "plain_max_abs": want.abs().max().item()},
            ok=bad == 0))
    return rows


# --------------------------------------------------------------------------
# forward on the card vs the CPU, and the detector end to end
# --------------------------------------------------------------------------

def check_small_forward(dev, seed):
    from maskrcnn_tpu_torch.core.config import tiny_test_config
    from maskrcnn_tpu_torch.models import mask_rcnn as M
    cfg = tiny_test_config().replace(compute_dtype="float32",
                                     detection_score_threshold=0.25)
    gen = torch.Generator().manual_seed(seed)
    params = M.init_mask_rcnn(gen, cfg)
    live_bn(params, gen)
    images = torch.rand((2, 128, 128, 3), generator=gen) * 255
    ref = M.to_numpy(M.forward(params, images, cfg, device="cpu"))
    out = M.to_numpy(M.forward(params, images, cfg, device=dev))
    same = {k: bool(np.array_equal(out[k], ref[k]))
            for k in ("roi_valid", "valid")}
    same["classes"] = bool(np.array_equal(out["detections"][..., 4],
                                          ref["detections"][..., 4]))
    errs = {k: float(np.abs(out[k] - ref[k]).max())
            for k in ("rois", "detections", "masks")}
    emit({"phase": "small_forward_vs_cpu", "equal": same, "max_abs_err": errs,
          "tol": 1e-4, "detections": int(ref["valid"].sum())})
    if not all(same.values()) or max(errs.values()) > 1e-4:
        raise AssertionError("forward on the card disagrees with the CPU")


KERNEL_GROUPS = (("K1 nms", "nms_kernel"), ("K2 roi_align", "roi_align_kernel"),
                 ("K3 stem", "stem_kernel"),
                 ("K4 bottleneck", "bottleneck_kernel"))


def profile_forward(detector, canvases) -> dict:
    """Device time of one forward batch by kernel (torch.profiler): the
    four port kernels, the rest by name, and the device's busy share of the
    wall time."""
    from torch.profiler import ProfilerActivity, profile
    detector.run_batch(canvases)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        detector.run_batch(canvases)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us and getattr(ev, "device_type", None) is not None and \
                str(ev.device_type).endswith("CUDA"):
            rows.append((ev.key, us / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    groups = {g: sum(r[1] for r in rows if key in r[0])
              for g, key in KERNEL_GROUPS}
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms if wall_ms else None,
            "port_kernels_ms": groups, "device_kernels": len(rows),
            "launches": sum(r[2] for r in rows),
            "top": [[k[:90], ms, n] for k, ms, n in rows[:15]]}


def e2e(dev, seed, batch):
    from maskrcnn_tpu_torch.core.config import MaskRCNNConfig
    from maskrcnn_tpu_torch.models import mask_rcnn as M
    from maskrcnn_tpu_torch.ops import cuda_lib
    from maskrcnn_tpu_torch.pipeline.detector import MaskRCNNDetector
    cfg = MaskRCNNConfig()             # R101-FPN @ 1024^2, 81 classes, bf16
    gen = torch.Generator().manual_seed(seed)
    params = M.init_mask_rcnn(gen, cfg)
    live_bn(params, gen)
    det = MaskRCNNDetector(cfg, params, device=dev)
    low = MaskRCNNDetector(cfg.replace(detection_score_threshold=0.0),
                           det.params, device=dev)
    rng = np.random.default_rng(seed)
    images = [rng.integers(0, 256, s, dtype=np.uint8)
              for s in ((480, 640, 3), (800, 600, 3), (1024, 1024, 3),
                        (300, 900, 3))]

    def timed(detector):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = detector.detect_images(images, batch_size=batch)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    det.detect_images(images[:batch], batch_size=batch)        # warm-up
    cuda_lib.reset_launches()
    res_default, ms_default = timed(det)
    launches_default = dict(cuda_lib.launches)
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    res_low, ms_low = timed(low)                               # main path
    launches = dict(cuda_lib.launches)
    peak = torch.cuda.max_memory_allocated()

    canvases = torch.from_numpy(np.stack(
        [np.zeros((1024, 1024, 3), np.float32)] * batch))
    canvases[0] = torch.from_numpy(rng.uniform(0, 255, (1024, 1024, 3)))
    lat = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = low.run_batch(canvases)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    profile = profile_forward(low, canvases)
    finite = {k: bool(torch.isfinite(out[k].float()).all())
              for k in ("detections", "masks", "rois")}
    n_low = [len(r) for r in res_low]
    masks_ok = all(d.mask is not None and d.mask.shape == img.shape[:2]
                   for r, img in zip(res_low, images) for d in r)
    boxes_ok = all(np.isfinite(d.box).all() and d.score >= 0
                   for r in res_low for d in r)
    emit({"phase": "e2e", "config": "resnet101 1024x1024x3, 81 classes, "
          "bf16", "images": len(images), "batch_size": batch,
          "detect_images_ms": {"default_thresholds": ms_default,
                               "score_threshold_0": ms_low},
          "forward_batch_ms": lat,
          "detections_default": [len(r) for r in res_default],
          "detections_score_threshold_0": n_low,
          "max_memory_allocated_bytes": peak, "finite": finite,
          "profile": profile,
          "launches_default": launches_default, "launches": launches})
    if not (all(finite.values()) and masks_ok and boxes_ok):
        raise AssertionError("non-finite or malformed detector output")
    if min(n_low) != cfg.max_detections:
        raise AssertionError(f"expected {cfg.max_detections} detections per "
                             f"image at score threshold 0, got {n_low}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=2)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from maskrcnn_tpu_torch.models import mask_rcnn as M
    from maskrcnn_tpu_torch.ops import cuda_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    cuda_lib.load(verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": list(cuda_lib.SOURCES)})

    rng = np.random.default_rng(args.seed)
    gen = torch.Generator().manual_seed(args.seed)
    from maskrcnn_tpu_torch.core.config import MaskRCNNConfig
    params = M.init_mask_rcnn(gen, MaskRCNNConfig())
    live_bn(params, gen, gamma=(0.5, 1.5))
    params = M.params_to(params, dev)

    rows = check_nms(dev, rng, args.batch)
    pyramid = [torch.from_numpy(rng.standard_normal(
        (args.batch, s, s, 256)).astype(np.float32)).to(dev)
        .to(torch.bfloat16) for s in (256, 128, 64, 32)]
    rows += check_roi_align(dev, rng, args.batch, pyramid)
    del pyramid
    rows += check_stem(dev, rng, args.batch, params)
    rows += check_chains(dev, rng, args.batch, params)
    del params
    torch.cuda.empty_cache()

    check_small_forward(dev, args.seed)
    launches = e2e(dev, args.seed, args.batch)

    family = {"K1": "nms", "K2": "roi_align", "K3": "stem", "K4": "bottleneck"}
    for row in rows:
        row["launches"] = launches[family[row["name"][:2]]]
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
