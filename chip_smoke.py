"""Smoke run of the PyTorch port on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py [--seed 0] [--batch 2] [--kernels-only]

Phases, each printing one JSON line, any failure ends the run non-zero
(a failed kernel row once every kernel row has been read):

  device   the card (`torch.cuda.get_device_name`, nvidia-smi name and
           power limit); no card -> exit 2 before anything else
  build    nvcc builds the six kernels from `maskrcnn_tpu_torch/csrc`
  K1..K6   each kernel against its plain PyTorch version on the card at the
           main paths' shapes (R101-FPN @ 1024^2, batch --batch), with its
           time, the plain version's time, the least time the card could
           take (`bound_ms`) and, where one PyTorch call computes the same
           function, that call's time (`library_ms`, never used by the port;
           for K5 and K6 the unfused route, K2 and then the head, several
           calls); every `ms` is back-to-back calls between CUDA events;
           every row with `share_of_bound` (bound_ms / ms); K2-K6 also
           with L2 cold (`ms_l2_cold`: a 256 MB buffer written before each
           timed call) and their rate (`tflops`); K1, K2 and K3 also as 20
           calls in one CUDA graph (`ms_graph`: the kernels without the
           wrappers' host time); K1, K3-K6 with the device kernels one call
           launches and their device times (torch.profiler), K5 and K6
           with their pool pass's time (`pool_pass_ms`); K3 a second time
           at 804 x 1060, whose pooled grid its tile does not divide;
           K3, each K4 block alone (on the plain chain's input to it), K5
           (h1, logits, deltas) and K6 (conv 3, conv 4, masks) also
           against the float64 plain version over 8 images (the check's
           input and fresh draws of its shape; K5/K6: new pyramids and
           ROIs, valid ROIs only): kernel - plain in bf16 ulps, signed,
           held to the rule of `tools/kernel_bias.py` (a lean or a larger
           error that the max-error check lets through fails the run);
           then K1-K4 again at batch 8, the serve_probe path's shapes
           (every forward there padded to its max batch 8), held to the
           same tolerances (in the `kernels` line as `serve_probe_batch`)
  native   the host native library (`maskrcnn_tpu_torch/native`, g++ at
           first use): which of librle, libimageio (with or without its
           libjpeg entry points) and libevalmatch loaded, the build
           errors, g++'s version, the host CPU and nproc; each native
           function against its PIL/numpy fallback (letterbox and JPEG
           decode+letterbox within 2 levels, JPEG decode bit-exact where
           libjpeg is in, paste flips under 2e-3 of the image per
           detection, RLE encode/decode and mask IoU and the COCO matcher
           equal, box IoU within 1e-12), with host ms of both at the
           serving path's sizes (letterbox 480x640 and 1024x768 -> 1024,
           JPEG bytes decode+letterbox, 100 detections pasted into
           768x1024, their encode_region and to_coco_counts, iou_masks
           100x20, match_all_areas over 400 random cases); fails if a
           library did not load. The e2e, serve and cli lines carry
           `host_native`: the parts their host work ran on
  small    the detector forward on the card against the same forward on the
           CPU (plain path), tiny config in float32
  e2e      `MaskRCNNDetector.detect_images` at R101-FPN @ 1024^2, 81 classes,
           bf16, random weights from --seed with BN statistics drawn from the
           seed, over 4 letterboxed images of mixed sizes, batch 2: once at
           the default thresholds, once with the score threshold at 0 so
           100 detections per image reach the mask branch (the first main
           path: the launch counts are zeroed just before it and read just
           after; it must launch K1..K4)
  stream   `run_stream` with the fused heads (K5, K6) and on-device mask
           paste at 1024^2, score threshold 0, over 16 synthetic frames
           in micro-batches of --batch (the second main path, counted
           the same way: K5 and K6 once per forward, K2 never), then one
           profiled forward
  train    training at R101-FPN @ 1024^2, 81 classes, bf16, batch --batch
           on a fixed synthetic batch (8 GT boxes an image, 28^2
           mini-masks), random weights from the seed with live BN: one
           `train_step` at the tiny config in float32 on the card against
           the CPU (phase train_small_vs_cpu); the K3, K4 and K2 autograd
           Functions at the training shapes (K2: 200 ROIs an image, pool 7
           and 14, bf16): each forward against the kernel's plain version
           (K2 bit for bit) and each gradient against the plain graph's
           (the graph is not cut), with each backward's time
           (train_grad_*); then per configuration (batch BN: K1, K2;
           frozen BN, the control, 1 warm-up and 2 timed steps: K1, K2;
           frozen BN + train_fused_kernels: K1-K4; the same with remat,
           1 and 2: K3 and K4 twice a step) the first
           step's gradients (every conv and dense kernel nonzero, conv1,
           res2a_branch2a, res3b_branch2b and fpn_p2 among them), 2 warm-up
           and 5 timed steps (the main path, counted as above: step time
           p50 / p95, images/s, peak memory; frozen BN must leave every BN
           tensor as it was), one profiled step (device time by kernel,
           busy share), and after the batch-BN steps
           `calibrate_bn_stats` over 2 batches
  serve    `pipeline/serve.make_server` (max batch --batch, 20 ms window,
           uint8 wire) on a thread, the default (unfused) config at score
           threshold 0: 8 concurrent POST /detect from 8 threads, twice,
           JPEG and PNG bodies of mixed sizes with one grayscale and one
           RGBA image, then one malformed body (must be 500, every other
           reply 200); boxes inside their images, every mask RLE of its
           image's size, a batch of more than one request, /healthz
           counting the frames, K3 once and K1 twice per forward;
           requests/s, latency p50/p95, peak memory; then the same
           traffic in turns on the PIL/numpy host fallback and on the
           native host path (fallback, native, native, fallback):
           requests/s and p50 of each turn
  serve_probe  `maskrcnn_tpu_torch/tools/serve_probe.py` (its `main`) on
           the default config at score threshold 0 (a config JSON), random
           weights from the seed, uint8 wire, max batch 8: a warm-up round
           of 16 requests, then K = 1 and 4 concurrent clients at 16
           requests each (a main path: K1-K4, K3 once and K1 twice per
           forward); its sweep (requests/s, p50/p95/p99, batch histogram,
           each summing to its requests); fails if a request errs
  evaluate_bench  host only: `tools/bench_cocoeval.py` at 500 images in
           bbox and segm, native matcher and `--numpy` (equal AP and
           AR100), and `tools/bench_results_leg.py` at 500 images x 20
           detections, region and full-canvas paste (the same rows)
  cli      `maskrcnn_tpu_torch.cli.main` in-process over a temporary COCO
           workspace (4 JPEGs with polygon annotations, random weights
           from the seed as .npz): `evaluate --uint8` (both 12-number
           summaries, results.json and results.pb, K1-K4), `demo` (a PNG
           of the image's size), `stream --frames-dir --device-paste`
           with both fused heads (K5 and K6 once per forward), `train
           --synthetic --steps 3 --state --output` (a calibrated .npz) and
           then `--resume --steps 5` (to step 5; K1, K2)
  proof    `maskrcnn_tpu_torch/tools/flagship_proof.py`'s loop at R101-FPN
           @ 1024^2, 81 classes, at small depth: its synthetic COCO set
           (4 train, 2 val images from the seed), `cli train` 20 steps at
           --batch (checkpoint every 10) and `--resume --steps 30` (from
           step 20), each calibrating BN (K1, K2; every logged loss
           finite); `cli evaluate` on the 2 val images in production
           numerics (K1-K4) and exact numerics (float32, TF32 off: its
           launches printed), scored by the tool's `score` and
           `cross_mode_deltas` (AP printed, not judged); `evaluate
           --compare-tf` (exit 2 naming TensorFlow where TF is absent,
           as on the card's machine; else on one image)
  mnv2     MobileNetV2-FPN @ 1024^2, 81 classes, bf16, random weights
           from the seed with live BN: `detect_images` over the e2e images
           at the default and the zero score threshold (a main path, K1 and
           K2, never K3 or K4), the forward's time and profile,
           `run_stream` with both fused heads over 8 frames (a main path:
           K5 and K6 once a forward), batch-BN `train_step` (1 warm-up, 3
           timed: a main path, K1 and K2)
  export   `io/export.py`: the R101-FPN @ 1024^2 forward exported on the
           card at batch 1 (trace seconds, program bytes), reloaded in this
           process (a main path: K1-K4) and in a new one, each within 1e-4
           of the eager forward with `valid` equal; the program's forward
           time beside the eager one's
  dp       `MaskRCNNDetector(data_parallel=-1)` over the cards present
           against one device, bit for bit (4 float32 images, odd uint8
           batch; a main path); the DP train step over NCCL at world 1
           against `train_step` (float32, frozen BN; bounds of
           `tests/test_parallel.py`'s n = 1); gloo at world 2 on the one
           card (two spawned ranks, one image each, R101 @ 1024^2 bf16):
           frozen and batch BN steps against one process's step on both
           images (loss 5e-2 relative, params 1e-4), and the batch-BN
           statistics at three layers against one process's over the
           gathered inputs (1e-5 relative); `parallel.mesh.dryrun_step(1)`
           (its default: NCCL, rank 0 on card 0)
  custom_op_dispatch  the e2e forward's wall ms and device launches with
           every kernel called through its custom op, beside the same
           forward's numbers before the ops
  bench    `maskrcnn_tpu_torch.tools.bench` at --batch, 10 iterations,
           with `--fuse none`, `--fuse both` and `--arch mobilenetv2`,
           then `--mode train` with
           batch BN and with frozen BN + `--train-fused-kernels` (1 warm-up
           and 2 timed steps: that it runs, launches and exits 0; the train
           phase has the times); its JSON lines

then a `kernels` line (each kernel's launches on the e2e or stream path,
on every path in `launches_by_path`, for K1-K4 their numbers at the
serve_probe path's batch in `serve_probe_batch`, per training step of
each training configuration in `train_launches_per_step`, and for K2-K4
the training
Function's forward and backward times and its forward's error), the
nvidia-smi line, and last
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import argparse
import json
import re
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


def cuda_ms_graph(fn, reps: int = 20, replays: int = 10) -> float:
    """Mean device time of fn() with the host's dispatch taken out: `reps`
    calls captured in one CUDA graph, replayed `replays` times between CUDA
    events. For kernels shorter than the wrapper's Python, where
    back-to-back calls time the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def kernels_per_call(fn, reps: int = 3) -> dict:
    """The device kernels one call of fn launches (the port's and
    PyTorch's), by name and in all: torch.profiler over `reps` calls after
    a warm-up. A trace that shows no device kernel at all (the profiler
    loses one now and then) is taken again, three times at most; None
    where none showed any."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name, ms_by_name = {}, {}
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0.0)
            if us and str(getattr(ev, "device_type", "")).endswith("CUDA"):
                key = re.sub(r"\(anonymous namespace\)::|\(.*|^void ", "",
                             ev.key)[:60]
                by_name[key] = by_name.get(key, 0) + ev.count / reps
                ms_by_name[key] = ms_by_name.get(key, 0) + us / reps / 1e3
        if by_name:
            return {"kernel_launches_per_call": sum(by_name.values()),
                    "kernels_per_call": by_name,
                    "kernel_ms_per_call": ms_by_name,
                    "profiler_attempts": attempt + 1}
    return {"kernel_launches_per_call": None, "kernels_per_call": None,
            "kernel_ms_per_call": None, "profiler_attempts": 3}


def pool_pass_ms(per_call: dict):
    """K2's pool kernel's device time inside a K5 / K6 call (profiler)."""
    ms = per_call.get("kernel_ms_per_call") or {}
    return sum(v for k, v in ms.items() if "roi_align_kernel" in k) or None


def cuda_ms_l2_cold(fn, reps: int, warmup: int = 1,
                    flush_bytes: int = 256 << 20) -> float:
    """Mean device time of fn() with L2 cold: before each timed call a
    `flush_bytes` buffer (5x the H100's 50 MB L2) is written, so weights and
    inputs left in L2 by the last call are gone; CUDA events around fn()
    alone."""
    flush = torch.empty(flush_bytes // 4, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for i in range(reps):
        flush.fill_(float(i))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    del flush
    return total / reps


def tflops(ms: float, flops: float) -> dict:
    """The rate a kernel achieves on the operations its bound counts."""
    return {"tflops": flops / ms / 1e9}


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
    """One kernel's row, `ok` (default: err <= tol) in it: `main` reads
    every kernel's rows and then fails on any that is not ok."""
    t_bound, by = bnd
    row = {"name": name, "route": route, "source": source,
           "replaces": replaces, "launches": None, "max_abs_err": err,
           "tol": tol, "ms": ms, "plain_ms": plain_ms, "bound_ms": t_bound,
           "bound_by": by, "share_of_bound": t_bound / ms,
           "library_ms": library_ms}
    row.update(extra or {})
    row["ok"] = bool(err <= tol if ok is None else ok)
    emit({"phase": name, **row})
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
        call = lambda: nms_cuda.nms_keep(boxes, cand, t, max_out)
        ms = cuda_ms(call, 50)
        ms_graph = cuda_ms_graph(call)
        plain_ms = cuda_ms(
            lambda: nms_cuda.nms_keep_plain(boxes, cand, t, max_out), 2, 1)
        tests = nms_work(boxes, want, cand, t, max_out)
        rows.append(record(
            f"K1_nms_{stage}", "cuda", "maskrcnn_tpu_torch/csrc/nms.cu",
            "maskrcnn_tpu/ops/nms_pallas.py:184", ms, plain_ms,
            idx_err, 0.0,
            bound(nbytes(boxes, cand) + cand.numel(), 20.0 * tests,
                  F32_FLOPS), None,
            {"ms_graph": ms_graph, "shape": [batch, n], "iou": t,
             "max_out": max_out,
             "kept": int(gv.sum()), "iou_tests": tests,
             "chunks_walked": [
                 (int(gi[i][gv[i]].max()) if int(gv[i].sum()) == max_out
                  else n - 1) // 64 + 1 for i in range(batch)],
             **kernels_per_call(call)}))
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
        ms_graph = cuda_ms_graph(lambda: roi_align_cuda.roi_align(*args))
        ms_cold = cuda_ms_l2_cold(lambda: roi_align_cuda.roi_align(*args), 10)
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
            {"ms_graph": ms_graph, "ms_l2_cold": ms_cold,
             **tflops(ms, 10.0 * got.numel()),
             "rois": [batch, n], "rois_per_level": levels,
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
# K5 pool-7 + classifier head, K6 pool-14 + mask head
# --------------------------------------------------------------------------

def fresh_pyramid(rng, like):
    """New draws of a pyramid's shape (the bias readings' further inputs)."""
    return [torch.from_numpy(rng.standard_normal(tuple(f.shape))
                             .astype(np.float32)).to(f.device)
            .to(torch.bfloat16) for f in like]


def head_bias(audit, names, rng, batch, pyramid, n, draw):
    """K5's or K6's rows of the rule of `tools/kernel_bias.py` over
    `bias_draws(batch)` inputs: `draw(rng, pyramid)` -> the audit's
    arguments after the pyramid; the first on the check's own pyramid."""
    from maskrcnn_tpu_torch.tools import kernel_bias as kb
    stats = {name: kb.BiasStats() for name in names}
    for i in range(bias_draws(batch)):
        pyr = pyramid if i == 0 else fresh_pyramid(rng, pyramid)
        args = draw(rng, pyr)
        audit(stats, pyr, *args, kb.head_rows(batch, n, args[3]))
        del pyr, args
    return {name: kb.decided(st) for name, st in stats.items()}


def check_fused_heads(dev, rng, batch, pyramid, params):
    """K5 and K6 against their plain versions (max error; K5's argmax),
    and each against its float64 plain version too: the lean of kernel -
    plain (`bias_by_row`, the rule of `tools/kernel_bias.py`, over
    `bias_draws(batch)` inputs)."""
    from maskrcnn_tpu_torch.models import heads
    from maskrcnn_tpu_torch.ops import roi_align as ra
    from maskrcnn_tpu_torch.ops import roi_align_cuda as rac
    from maskrcnn_tpu_torch.tools import kernel_bias as kb
    hw = [(f.shape[1], f.shape[2]) for f in pyramid]
    c = pyramid[0].shape[-1]
    nc = 81
    bf16 = torch.bfloat16
    rows = []

    n = 1000
    rois = spread_rois(rng, batch, n).to(dev)
    prep = ra.prepare(rois.reshape(-1, 4), hw, (1024, 1024), 224.0, 7)
    head = rac.pack_classifier_head(params, nc, bf16)
    args = (pyramid, *prep, n, head)
    want = rac.classifier_head_plain(*args)
    got = rac.roi_classifier_head(*args)
    lanes = torch.cat([torch.arange(nc), torch.arange(128, 128 + 4 * nc)])
    err = (got - want)[:, lanes].abs().max().item()
    # h1, h2 rounded to bf16 at the same points after float32 sums in
    # another order: an ulp of a hidden unit moves the outputs by far less
    # than 2% of their largest value; the class argmax may flip only where
    # two logits nearly tie
    tol = 0.02 * want[:, lanes].abs().max().item()
    argmax_same = (got[:, :nc].argmax(1) == want[:, :nc].argmax(1)
                   ).float().mean().item()

    def draw_rois(rng, pyr):
        if pyr is pyramid:
            return (*prep, n, head, nc)
        return (*ra.prepare(spread_rois(rng, batch, n).to(dev).reshape(-1, 4),
                            hw, (1024, 1024), 224.0, 7), n, head, nc)

    lean = head_bias(kb.audit_classifier_head, kb.K5_ROWS, rng, batch,
                     pyramid, n, draw_rois)
    ms = cuda_ms(lambda: rac.roi_classifier_head(*args), 20)
    ms_cold = cuda_ms_l2_cold(lambda: rac.roi_classifier_head(*args), 10)
    plain_ms = cuda_ms(lambda: rac.classifier_head_plain(*args), 3)
    library_ms = cuda_ms(lambda: heads.apply_classifier_head(
        params, rac.roi_align(pyramid, *prep, n), nc, dtype=bf16), 20)
    per_call = kernels_per_call(lambda: rac.roi_classifier_head(*args))
    m = batch * n
    k1, n1 = head["w1"].shape
    n2, n3 = head["w2"].shape[1], head["w3"].shape[1]
    cells = distinct_cells(*prep, n, hw)
    moved = (nbytes(*head.values()) + cells * c * pyramid[0].element_size()
             + nbytes(got, *prep))
    flops = 2.0 * m * (k1 * n1 + n1 * n2 + n2 * n3)
    bnd = bound(moved, flops, BF16_FLOPS)
    rows.append(record(
        "K5_roi_classifier_head", "cuda",
        "maskrcnn_tpu_torch/csrc/roi_classifier_head.cu",
        "maskrcnn_tpu/ops/roi_align_pallas.py:716", ms, plain_ms, err,
        tol, bnd, library_ms,
        {"ms_l2_cold": ms_cold, **tflops(ms, flops),
         "rois": [batch, n], "widths": [k1, n1, n2, n3],
         "argmax_same": argmax_same, "argmax_tol": 0.995,
         **per_call, "pool_pass_ms": pool_pass_ms(per_call),
         "distinct_cells": cells,
         "library": "K2 pool 7, then models/heads.py (cuBLAS): several "
                    "calls", "plain_max_abs": want.abs().max().item(),
         "bias_by_row": lean, "bias_rule": kb.RULE},
        ok=err <= tol and argmax_same >= 0.995
        and all(r["rule"]["unbiased"] for r in lean.values())))

    n = 100
    rois = spread_rois(rng, batch, n).to(dev)
    prep = ra.prepare(rois.reshape(-1, 4), hw, (1024, 1024), 224.0, 14)
    mask = rac.pack_mask_head(params, bf16)
    ids = torch.from_numpy(rng.integers(1, nc, batch * n)
                           .astype(np.int32)).to(dev)
    args = (pyramid, *prep, n, mask, ids)
    want = rac.mask_head_plain(*args)
    got = rac.roi_mask_head(*args)
    err = (got - want).abs().max().item()

    def draw_dets(rng, pyr):
        if pyr is pyramid:
            return (*prep, n, mask, ids)
        return (*ra.prepare(spread_rois(rng, batch, n).to(dev).reshape(-1, 4),
                            hw, (1024, 1024), 224.0, 14), n, mask,
                torch.from_numpy(rng.integers(1, nc, batch * n)
                                 .astype(np.int32)).to(dev))

    lean = head_bias(kb.audit_mask_head, kb.K6_ROWS, rng, batch, pyramid,
                     n, draw_dets)
    ms = cuda_ms(lambda: rac.roi_mask_head(*args), 20)
    ms_cold = cuda_ms_l2_cold(lambda: rac.roi_mask_head(*args), 10)
    plain_ms = cuda_ms(lambda: rac.mask_head_plain(*args), 3)
    library_ms = cuda_ms(lambda: heads.apply_mask_head(
        params, rac.roi_align(pyramid, *prep, n), dtype=bf16,
        class_ids=ids), 10)
    per_call = kernels_per_call(lambda: rac.roi_mask_head(*args))
    m = batch * n
    flops = 2.0 * m * 196 * (4 * 9 * c * c + c * 4 * c)
    cells = distinct_cells(*prep, n, hw)
    moved = (nbytes(*mask.values()) + cells * c * pyramid[0].element_size()
             + nbytes(got, ids, *prep))
    # four bf16 activation roundings after float32 sums in another order,
    # then a sigmoid (slope at most 1/4)
    rows.append(record(
        "K6_roi_mask_head", "cuda", "maskrcnn_tpu_torch/csrc/roi_mask_head.cu",
        "maskrcnn_tpu/ops/roi_align_pallas.py:716", ms, plain_ms, err, 1e-2,
        bound(moved, flops, BF16_FLOPS), library_ms,
        {"ms_l2_cold": ms_cold, **tflops(ms, flops),
         **per_call, "pool_pass_ms": pool_pass_ms(per_call),
         "rois": [batch, n], "distinct_cells": cells,
         "library": "K2 pool 14, then models/heads.py (cuDNN convs, "
                    "einsum select): several calls",
         "mean_abs_err": (got - want).abs().mean().item(),
         "bias_by_row": lean, "bias_rule": kb.RULE},
        ok=err <= 1e-2 and all(r["rule"]["unbiased"]
                               for r in lean.values())))
    return rows


# --------------------------------------------------------------------------
# K3 stem, K4 bottleneck chains
# --------------------------------------------------------------------------

# float32 sums in another order before one bf16 rounding: a value may land
# on the next bf16 number, one ulp away (8 significant bits: 2^-8 to 2^-7
# of the value, so 2^-8 relative is less than an ulp), plus slack at zero
STEM_TOL = ("ulp", 1e-3)
# bf16 intermediates rounded at the same points, float32 sums in another
# order: an ulp that later blocks carry on
CHAIN_TOL = (0.02, 0.01)


def bf16_ulp(x):
    """The spacing of bfloat16 numbers at |x|: 2^(e-8) for |x| in
    [2^(e-1), 2^e)."""
    _, e = torch.frexp(x.abs())
    return torch.ldexp(torch.ones_like(x), e - 8)


def over_tol(got, want, tol) -> tuple[float, int, str]:
    """max |got - want| and the number of elements over rel*|want| (for
    rel "ulp": one bf16 ulp at the larger of |got|, |want|) +
    abs*max|want|, with the tolerance as text."""
    rel, of_max = tol
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if rel == "ulp":
        allowed, text = bf16_ulp(torch.maximum(got.abs(), want.abs())), \
            "1 bf16 ulp"
    else:
        allowed, text = rel * want.abs(), f"{rel}*|plain|"
    bad = int((err > allowed + of_max * want.abs().max()).sum())
    return err.max().item(), bad, f"{text} + {of_max}*max|plain| each"


def bias_draws(batch) -> int:
    """Inputs the bias readings of K3-K6 take at `batch`: the check's
    own and fresh draws of its shape, 8 images in all (the readings'
    spread shrinks with the elements they see)."""
    return max(1, 8 // batch)


def check_stem(dev, rng, batch, params):
    """K3 at the main path's 1024^2, then at a size whose pooled grid
    (201 x 265) the kernel's 12 x 7 tile does not divide. Each also
    against the float64 plain version: the lean of kernel - plain
    (`bias`, the rule of `tools/kernel_bias.py`)."""
    from maskrcnn_tpu_torch.ops import stem_cuda
    from maskrcnn_tpu_torch.tools import kernel_bias as kb
    w, bias = stem_cuda.fold_stem_weights(params["conv1"], params["bn_conv1"])
    wc = w.permute(3, 2, 0, 1).contiguous()
    bc = bias.to(torch.bfloat16)
    rows = []
    for name, (h, wd) in (("K3_stem", (1024, 1024)),
                          ("K3_stem_ragged", (804, 1060))):
        images = torch.from_numpy(rng.uniform(-124, 132, (batch, h, wd, 3))
                                  .astype(np.float32)).to(dev)
        want = stem_cuda.stem_plain(images, w, bias).float()
        got = stem_cuda.stem(images, w, bias).float()
        err, bad, tol = over_tol(got, want, STEM_TOL)
        stats = kb.BiasStats()
        kb.audit_stem(stats, images, w, bias)
        for _ in range(bias_draws(batch) - 1):
            kb.audit_stem(stats, torch.from_numpy(rng.uniform(
                -124, 132, images.shape).astype(np.float32)).to(dev), w, bias)
        lean = kb.decided(stats)
        call = lambda: stem_cuda.stem(images, w, bias)
        ms = cuda_ms(call, 20)
        ms_graph = cuda_ms_graph(call)
        ms_cold = cuda_ms_l2_cold(call, 10)
        plain_ms = cuda_ms(lambda: stem_cuda.stem_plain(images, w, bias), 3)

        def library():
            y = F.conv2d(images.permute(0, 3, 1, 2).to(torch.bfloat16), wc,
                         bc, stride=2, padding=3)
            return F.max_pool2d(F.pad(torch.relu(y), (0, 1, 0, 1)), 3, 2)

        library_ms = cuda_ms(library, 20)
        flops = 2.0 * batch * (h // 2) * (wd // 2) * 64 * 147
        rows.append(record(
            name, "cuda", "maskrcnn_tpu_torch/csrc/stem.cu",
            "maskrcnn_tpu/ops/stem_pallas.py:197", ms, plain_ms, err, tol,
            bound(nbytes(images, w, bias) + got.numel() * 2, flops,
                  BF16_FLOPS), library_ms,
            {"ms_graph": ms_graph, "ms_l2_cold": ms_cold,
             **tflops(ms, flops), "shape": list(images.shape),
             "elements_over_tol": bad, **kernels_per_call(call),
             "plain_max_abs": want.abs().max().item(), "bias": lean,
             "bias_rule": kb.RULE},
            ok=bad == 0 and lean["rule"]["unbiased"]))
        del images, want, got
    return rows


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
    """Each K4 chain against the plain chain, then each block alone on
    the plain chain's input to it against the float32 and float64 plain
    block: the lean of kernel - plain (`bias_by_block`, the rule of
    `tools/kernel_bias.py`)."""
    from maskrcnn_tpu_torch.ops import bottleneck_cuda as bc
    from maskrcnn_tpu_torch.tools import kernel_bias as kb
    rows = []
    for stage, letters, hw, cin in ((2, "abc", 256, 64), (3, "bcd", 128, 512)):
        blocks = bc.fold_bottleneck_chain(params, stage, letters)
        x = torch.from_numpy(rng.standard_normal((batch, hw, hw, cin))
                             .astype(np.float32)).to(dev).to(torch.bfloat16)
        want = bc.chain_plain(x, blocks).float()
        got = bc.fused_bottleneck_chain(x, blocks).float()
        err, bad, tol = over_tol(got, want, CHAIN_TOL)
        stats = [kb.BiasStats() for _ in blocks]
        kb.audit_chain(stats, x, blocks)
        for _ in range(bias_draws(batch) - 1):
            kb.audit_chain(stats, torch.from_numpy(rng.standard_normal(
                x.shape).astype(np.float32)).to(dev), blocks)
        lean = {f"res{stage}{letter}": kb.decided(st)
                for letter, st in zip(letters, stats)}
        del stats
        ms = cuda_ms(lambda: bc.fused_bottleneck_chain(x, blocks), 10)
        ms_cold = cuda_ms_l2_cold(
            lambda: bc.fused_bottleneck_chain(x, blocks), 10)
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
        flops = chain_flops(x.shape, blocks)
        bnd = bound(nbytes(x) + got.numel() * 2 + wbytes, flops, BF16_FLOPS)
        rows.append(record(
            f"K4_chain_res{stage}{letters}", "cuda",
            "maskrcnn_tpu_torch/csrc/bottleneck.cu",
            "maskrcnn_tpu/ops/bottleneck_pallas.py:213", ms, plain_ms, err,
            tol, bnd, library_ms,
            {"ms_l2_cold": ms_cold, **tflops(ms, flops),
             "shape": list(x.shape), "cout": blocks[-1]["w3"].shape[1],
             "elements_over_tol": bad,
             **kernels_per_call(
                 lambda: bc.fused_bottleneck_chain(x, blocks)),
             "plain_max_abs": want.abs().max().item(),
             "bias_by_block": lean, "bias_rule": kb.RULE},
            ok=bad == 0 and all(r["rule"]["unbiased"]
                                for r in lean.values())))
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


# Profile groups by kernel name. roi_align_kernel is K2 on the e2e path and
# the pool pass of K5 and K6 on the stream path (each pools once, then runs
# its GEMMs).
KERNEL_GROUPS = (("K1 nms", ("nms_mask_kernel", "nms_walk_kernel")),
                 ("K2 roi_align", ("roi_align_kernel",)),
                 ("K3 stem", ("stem_kernel",)),
                 ("K4 bottleneck", ("bottleneck_kernel",)),
                 ("K5 roi_classifier_head", ("head_gemm_kernel",
                                             "split_sum_kernel")),
                 ("K6 roi_mask_head", ("mask_conv_kernel",
                                       "mask_deconv_kernel")))
E2E_KERNELS = ("nms", "roi_align", "stem", "bottleneck")
STREAM_KERNELS = ("nms", "stem", "bottleneck", "roi_classifier_head",
                  "roi_mask_head")


def profile_forward(detector, canvases, paste_size=None) -> dict:
    """Device time of one forward batch by kernel (torch.profiler): the
    port kernels, the rest by name, and the device's busy share of the
    wall time."""
    detector.run_batch(canvases, paste_size=paste_size)
    return profile_call(lambda: detector.run_batch(canvases,
                                                   paste_size=paste_size))


def profile_call(fn) -> dict:
    """One call of fn under torch.profiler (after the caller's warm-up):
    device time by kernel, the port kernels by group, and the device's
    busy share of the host's wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    groups = {g: sum(r[1] for r in rows if any(k in r[0] for k in keys))
              for g, keys in KERNEL_GROUPS}
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms if wall_ms else None,
            "port_kernels_ms": groups, "device_kernels": len(rows),
            "launches": sum(r[2] for r in rows),
            "top": [[k[:90], ms, n] for k, ms, n in rows[:15]]}


def e2e_images(rng):
    """The 4 uint8 images of mixed sizes `detect_images` gets."""
    return [rng.integers(0, 256, s, dtype=np.uint8)
            for s in ((480, 640, 3), (800, 600, 3), (1024, 1024, 3),
                      (300, 900, 3))]


def timed_detect(detector, images, batch):
    """`detect_images` in batches of `batch`, and its wall ms."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = detector.detect_images(images, batch_size=batch)
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3


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
    images = e2e_images(rng)

    def timed(detector):
        return timed_detect(detector, images, batch)

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
          "launches_default": launches_default, "launches": launches,
          "host_native": host_native()})
    # every kernel call of this forward goes through its custom op
    # (`maskrcnn_tpu_torch::*`); the `reference_` keys are not of this run:
    # the same forward before the ops, as PERF.md records it
    emit({"phase": "custom_op_dispatch", "forward_batch_ms": lat,
          "device_launches": profile["launches"],
          "kernel_calls_per_forward": {k: v * batch / len(images)
                                       for k, v in launches.items()},
          "reference_before_ops_forward_batch_ms": [41.6, 44.5],
          "reference_before_ops_device_launches": 2051,
          "reference_before_ops_card": "NVIDIA H100 80GB HBM3, 700.00 W",
          "reference_source": "PERF.md section 6, PR 7 chip run, not "
                              "measured in this run"})
    if not (all(finite.values()) and masks_ok and boxes_ok):
        raise AssertionError("non-finite or malformed detector output")
    if min(n_low) != cfg.max_detections:
        raise AssertionError(f"expected {cfg.max_detections} detections per "
                             f"image at score threshold 0, got {n_low}")
    missing = [k for k in E2E_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    return launches


def stream(dev, seed, batch, frames=16):
    """`run_stream` through the fused heads with on-device paste."""
    from maskrcnn_tpu_torch.core.config import MaskRCNNConfig
    from maskrcnn_tpu_torch.models import mask_rcnn as M
    from maskrcnn_tpu_torch.ops import cuda_lib
    from maskrcnn_tpu_torch.pipeline.detector import MaskRCNNDetector
    from maskrcnn_tpu_torch.pipeline.stream import (run_stream,
                                                    synthetic_frames)
    cfg = MaskRCNNConfig(fuse_classifier_head=True, fuse_mask_head=True,
                         detection_score_threshold=0.0)
    gen = torch.Generator().manual_seed(seed)
    params = M.init_mask_rcnn(gen, cfg)
    live_bn(params, gen)
    det = MaskRCNNDetector(cfg, params, device=dev)
    size = cfg.image_height
    warm = np.stack(list(synthetic_frames(batch, size, seed + 1)))
    det.run_batch(warm, paste_size=size)                      # warm-up
    torch.cuda.synchronize()
    last = {}
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    stats = run_stream(det, synthetic_frames(frames, size, seed),
                       on_result=lambda i, out: last.update(out=out),
                       micro_batch=batch, paste_size=size,
                       latency_probes=10, sync_every=8)   # main path
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launches)
    peak = torch.cuda.max_memory_allocated()
    forwards = -(-frames // batch) + stats.latency_probes

    out = last["out"]
    pasted = out["pasted"]
    boxes = out["detections"][..., :4]
    centers = (torch.arange(size, dtype=torch.float32, device=dev)
               + 0.5) / size
    in_y = (centers >= boxes[..., 0:1]) & (centers <= boxes[..., 2:3])
    in_x = (centers >= boxes[..., 1:2]) & (centers <= boxes[..., 3:4])
    outside = int((pasted.bool()
                   & ~(in_y[..., :, None] & in_x[..., None, :])).sum())
    finite = {k: bool(torch.isfinite(out[k].float()).all())
              for k in ("detections", "masks")}
    n_valid = out["valid"].sum(1).tolist()
    profile = profile_forward(det, torch.from_numpy(warm).to(dev), size)
    emit({"phase": "stream", "config": "resnet101 1024x1024x3, 81 classes, "
          "bf16, fuse_classifier_head + fuse_mask_head, score threshold 0",
          "frames": stats.frames, "micro_batch": batch, "paste_size": size,
          "fps": stats.fps, "wall_s": stats.wall_s,
          "p50_latency_ms": stats.p50_latency_ms,
          "p95_latency_ms": stats.p95_latency_ms,
          "p99_latency_ms": stats.p99_latency_ms,
          "latency_probes": stats.latency_probes, "forwards": forwards,
          "max_memory_allocated_bytes": peak, "launches": launches,
          "pasted": [list(pasted.shape), str(pasted.dtype)],
          "pasted_pixels_set": int(pasted.sum()),
          "pasted_pixels_outside_box": outside, "valid": n_valid,
          "finite": finite, "profile": profile})
    tail = frames - batch * (-(-frames // batch) - 1)   # last batch's size
    if tuple(pasted.shape) != (tail, cfg.max_detections, size, size) \
            or pasted.dtype != torch.uint8:
        raise AssertionError(f"pasted is {tuple(pasted.shape)} "
                             f"{pasted.dtype}")
    if outside or not all(finite.values()):
        raise AssertionError(f"{outside} pasted pixels outside their box, "
                             f"finite {finite}")
    if min(n_valid) != cfg.max_detections:
        raise AssertionError(f"expected {cfg.max_detections} detections "
                             f"per image at score threshold 0: {n_valid}")
    if launches["roi_align"]:
        raise AssertionError("the fused path launched K2 "
                             f"{launches['roi_align']} times")
    missing = [k for k in STREAM_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"stream path never launched {missing}")
    for k in ("roi_classifier_head", "roi_mask_head"):
        if launches[k] != forwards:
            raise AssertionError(f"{k} launched {launches[k]} times in "
                                 f"{forwards} forwards")
    return launches


# --------------------------------------------------------------------------
# training: the kernels under autograd, the train step, calibration
# --------------------------------------------------------------------------

def leaf_grads(fn, params, x, cot, retain=False):
    """fn(params, x) and the gradients of sum(out * cot) for every param
    leaf and x, by name; `retain` keeps the graph for timing backwards."""
    leaves = [(k, w) for k, d in params.items() for w in d]
    p = {k: {w: v.detach().clone().requires_grad_(True)
             for w, v in d.items()} for k, d in params.items()}
    xx = x.detach().clone().requires_grad_(True)
    out = fn(p, xx)
    inputs = [p[k][w] for k, w in leaves] + [xx]

    def backward():
        return torch.autograd.grad(out, inputs, cot, retain_graph=True)

    got = backward()
    grads = {**{f"{k}/{w}": g for (k, w), g in zip(leaves, got)},
             "x": got[-1]}
    return out, grads, backward


def grad_errors(got: dict, want: dict) -> dict:
    """max |got - want| of each gradient over its largest |want|."""
    return {k: (got[k].float() - w.float()).abs().max().item()
            / max(w.float().abs().max().item(), 1e-30)
            for k, w in want.items()}


def check_train_functions(dev, rng, batch, params):
    """The K3, K4 and K2 autograd Functions at the training path's full
    shapes: each forward (the kernel) against the kernel's plain version
    on the same inputs, with the tolerance of the kernel's own check (K2
    bit for bit); each gradient against the plain graph's with the same
    cotangent, which shows that the graph is not cut (the backward is
    that graph's vjp, recomputed); and the time of each backward beside
    the forward."""
    from maskrcnn_tpu_torch.models import resnet
    from maskrcnn_tpu_torch.ops import bottleneck_cuda as bc
    from maskrcnn_tpu_torch.ops import roi_align as ra
    from maskrcnn_tpu_torch.ops import roi_align_cuda as rac
    from maskrcnn_tpu_torch.ops import stem_cuda
    bf16 = torch.bfloat16
    # cuDNN's backward and the pool's index_put accumulate atomically, in
    # an order that may change between runs: each gradient within
    # TRAIN_GRAD_TOL of its largest value
    tol = TRAIN_GRAD_TOL
    rows = {}

    def run(name, fn, plain, kernel_plain, p, x, cot):
        """`kernel_plain(p, x, out)`: the Function's forward `out` against
        the kernel's plain version, as (max |diff|, elements over the
        tolerance, the tolerance)."""
        out, g_fn, bwd = leaf_grads(fn, p, x, cot)
        _, g_pl, bwd_plain = leaf_grads(plain, p, x, cot)
        with torch.no_grad():
            fwd_err, fwd_bad, fwd_tol = kernel_plain(p, x, out.detach())
        errs = grad_errors(g_fn, g_pl)
        worst = max(errs, key=errs.get)
        fwd_ms = cuda_ms(lambda: fn(p, x), 5, 1)
        bwd_ms = cuda_ms(bwd, 5, 1)
        plain_ms = cuda_ms(lambda: plain(p, x), 5, 1)
        plain_bwd_ms = cuda_ms(bwd_plain, 5, 1)
        row = {"fwd_max_abs_err": fwd_err, "fwd_elements_over_tol": fwd_bad,
               "fwd_tol": fwd_tol, "max_rel_grad_err": errs[worst],
               "worst_leaf": worst, "tol": tol, "shape": list(x.shape),
               "out": list(out.shape), "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
               "plain_fwd_ms": plain_ms, "plain_bwd_ms": plain_bwd_ms}
        rows[name] = row
        emit({"phase": f"train_grad_{name}", **row})
        if fwd_bad:
            raise AssertionError(f"{name}: the Function's forward is off the "
                                 f"kernel's plain version at {fwd_bad} "
                                 f"elements (max {fwd_err})")
        if errs[worst] > tol:
            raise AssertionError(f"{name}: gradient of {worst} off by "
                                 f"{errs[worst]} of its largest")

    h = 1024
    images = torch.from_numpy(rng.uniform(-124, 132, (batch, h, h, 3))
                              .astype(np.float32)).to(dev)
    cot = torch.randn((batch, h // 4, h // 4, 64), device=dev,
                      dtype=bf16)
    stem_p = {k: params[k] for k in ("conv1", "bn_conv1")}

    def stem_plain(p, x, out):
        w, bias = stem_cuda.fold_stem_weights(p["conv1"], p["bn_conv1"])
        return over_tol(out, stem_cuda.stem_plain(x, w, bias), STEM_TOL)

    run("K3_stem", stem_cuda.stem_fused_diff,
        lambda p, x: resnet._stem_layers(p, x, bf16), stem_plain, stem_p,
        images, cot)
    del images, cot

    for stage, letters, hw, cin, cout in ((2, "abc", 256, 64, 256),
                                          (3, "bcd", 128, 512, 512)):
        keys = bc.chain_keys(stage, letters)
        chain_p = {k: params[k] for k in keys}
        x = torch.randn((batch, hw, hw, cin), device=dev, dtype=bf16)
        cot = torch.randn((batch, hw, hw, cout), device=dev, dtype=bf16)

        def plain(p, xx, stage=stage, letters=letters):
            for letter in letters:
                xx = resnet._bottleneck(xx, p, stage, letter, letter == "a",
                                        1, bf16)
            return xx

        def chain_plain(p, xx, out, stage=stage, letters=letters):
            blocks = bc.fold_bottleneck_chain(p, stage, letters)
            return over_tol(out, bc.chain_plain(xx, blocks), CHAIN_TOL)

        run(f"K4_chain_res{stage}{letters}",
            lambda p, xx, stage=stage, letters=letters:
            bc.chain_fused_diff(p, stage, letters, xx), plain, chain_plain,
            chain_p, x, cot)
        del x, cot

    hw = [(s, s) for s in (256, 128, 64, 32)]
    n = 200                              # train_rois_per_image
    feats = [torch.randn((batch, s, s, 256), device=dev, dtype=bf16)
             for s, _ in hw]
    for crop in (7, 14):
        rois = spread_rois(rng, batch, n).to(dev)

        def pool(p, x, crop=crop, rois=rois):
            levels = [p["pyr"][f"P{i + 2}"] for i in range(3)] + [x]
            return ra.pyramid_roi_align(levels, rois, crop, (1024, 1024))

        def pool_plain(p, x, crop=crop, rois=rois):
            levels = [p["pyr"][f"P{i + 2}"] for i in range(3)] + [x]
            ys, xs, level, valid = ra.prepare(rois.reshape(-1, 4), hw,
                                              (1024, 1024), 224.0, crop)
            return rac.roi_align_plain(levels, ys, xs, level, valid, n
                                       ).reshape(batch, n, crop, crop, 256)

        def kernel_plain(p, x, out, pool_plain=pool_plain):
            # the kernel and the plain version do the same float32
            # operations in the same order: bit for bit
            want = pool_plain(p, x)
            err = (out.float() - want.float()).abs().max().item()
            return err, int((out != want).sum()), "bit-equal"

        pyr = {"pyr": {f"P{i + 2}": feats[i] for i in range(3)}}
        cot = torch.randn((batch, n, crop, crop, 256), device=dev,
                          dtype=bf16)
        run(f"K2_roi_align_pool{crop}", pool, pool_plain, kernel_plain, pyr,
            feats[3], cot)
    return rows


TRAIN_GRAD_TOL = 2e-2
TRAIN_CONFIGS = (
    # name, config overrides, warm-up steps, timed steps, kernels it must
    # launch, kernels it must not
    ("batch_bn", dict(train_bn="batch"), 2, 5, ("nms", "roi_align"),
     ("stem", "bottleneck")),
    # the control of train_fused_kernels: frozen BN through the layers, two
    # timed steps and the profiled one
    ("frozen_bn", dict(train_bn="frozen"), 1, 2, ("nms", "roi_align"),
     ("stem", "bottleneck")),
    ("frozen_bn_fused", dict(train_bn="frozen", train_fused_kernels=True), 2,
     5, ("nms", "roi_align", "stem", "bottleneck"), ()),
    # remat re-runs the backbone forward in the backward: K3 and K4 twice a
    # step
    ("frozen_bn_fused_remat", dict(train_bn="frozen",
                                   train_fused_kernels=True,
                                   train_remat_backbone=True), 1, 2,
     ("nms", "roi_align", "stem", "bottleneck"), ()),
)
CHECKED_LAYERS = ("conv1", "res2a_branch2a", "res3b_branch2b", "fpn_p2")


def train(dev, seed, batch):
    """`train_step` at R101-FPN @ 1024^2, 81 classes, bf16, batch `batch`,
    on a fixed synthetic batch (8 GT boxes an image, 28^2 mini-masks),
    random weights from the seed with live BN: for each configuration the
    first step's gradients (every conv and dense kernel nonzero), then
    warm-up and timed steps (the main path: the launch counts are zeroed
    just before them and read just after), then BN calibration after the
    batch-BN steps; and one step at the tiny config in float32 on the card
    against the CPU."""
    from maskrcnn_tpu_torch.core.anchors import generate_anchors
    from maskrcnn_tpu_torch.core.config import MaskRCNNConfig
    from maskrcnn_tpu_torch.models import mask_rcnn as M
    from maskrcnn_tpu_torch.ops import cuda_lib
    from maskrcnn_tpu_torch.train.data import synthetic_train_batch
    from maskrcnn_tpu_torch.train import step as T
    from maskrcnn_tpu_torch.train.calibrate import calibrate_bn_stats

    check_train_small(dev, seed)
    by_path, per_step, grad_rows = {}, {}, None
    for name, overrides, warm, timed, want, never in TRAIN_CONFIGS:
        cfg = MaskRCNNConfig(**overrides)
        gen = torch.Generator().manual_seed(seed)
        params = M.init_mask_rcnn(gen, cfg)
        live_bn(params, gen)
        params = M.params_to(params, dev)
        if grad_rows is None:
            grad_rows = check_train_functions(
                dev, np.random.default_rng(seed + 5), batch, params)
            torch.cuda.empty_cache()
        state, opt = T.make_train_state(params, cfg)
        data = synthetic_train_batch(cfg, batch, dev, seed=seed + 1)
        anchors = torch.from_numpy(generate_anchors(cfg)).to(dev)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        grads, metrics = T.compute_gradients(state, data, anchors, cfg, opt,
                                             seed=seed)
        first = {k: float(v) for k, v in metrics.items()}
        first_ms = (time.perf_counter() - t0) * 1e3
        zero = [layer for layer, ws in params.items() if "kernel" in ws
                and not grads[layer]["kernel"].abs().max().item() > 0]
        checked = {layer: grads[layer]["kernel"].abs().max().item()
                   for layer in CHECKED_LAYERS}
        state = T.apply_gradients(state, grads, opt)
        del grads
        losses = [first]
        for _ in range(warm):
            state, m = T.train_step(state, data, anchors, cfg, opt,
                                    seed=seed)
            losses.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        times = []
        for _ in range(timed):                               # main path
            t0 = time.perf_counter()
            state, m = T.train_step(state, data, anchors, cfg, opt,
                                    seed=seed)
            losses.append({k: float(v) for k, v in m.items()})  # readback
            times.append((time.perf_counter() - t0) * 1e3)
        launches = dict(cuda_lib.launches)
        peak = torch.cuda.max_memory_allocated()

        def one_step():
            nonlocal state
            state, _ = T.train_step(state, data, anchors, cfg, opt,
                                    seed=seed)

        profile = profile_call(one_step)
        bn_moved = [layer for layer, ws in params.items()
                    if "moving_variance" in ws
                    and any(not torch.equal(state.params[layer][w], v)
                            for w, v in ws.items())]
        finite = all(np.isfinite(v) for row in losses for v in row.values())
        p50, p95 = (float(np.percentile(times, q)) for q in (50, 95))
        row = {"phase": f"train_{name}", "config": describe(cfg)
               + f", {overrides}", "batch": batch,
               "first_step_ms": first_ms, "warmup_steps": warm,
               "timed_steps": timed, "step_ms": times, "step_ms_p50": p50,
               "step_ms_p95": p95, "images_per_s": batch / p50 * 1e3,
               "max_memory_allocated_bytes": peak, "losses_first": first,
               "losses_last": losses[-1], "finite": finite,
               "zero_grad_kernels": zero, "checked_grad_max": checked,
               "bn_layers_moved": len(bn_moved), "launches": launches,
               "profile": profile,
               "launches_per_step": {k: v / timed
                                     for k, v in launches.items()}}
        if name == "batch_bn":
            t0 = time.perf_counter()
            cal = calibrate_bn_stats(
                state.params, [synthetic_train_batch(
                    cfg, batch, dev, seed=seed + 10 + i)["images"]
                    for i in range(2)], anchors, cfg)
            row["calibrate_s"] = time.perf_counter() - t0
            mv = torch.cat([cal[k]["moving_variance"] for k in cal
                            if "moving_variance" in cal[k]])
            row["calibrated_moving_variance"] = [mv.min().item(),
                                                 mv.max().item()]
            if not (torch.isfinite(mv).all() and mv.min() >= 0
                    and cal["bn_conv1"]["moving_variance"].ne(
                        state.params["bn_conv1"]["moving_variance"]).any()):
                raise AssertionError("calibration left the statistics "
                                     "unchanged or not finite")
            del cal
        emit(row)
        by_path[f"train_{name}"] = launches
        per_step[name] = row["launches_per_step"]
        problems = []
        if not finite:
            problems.append("non-finite loss")
        if zero:
            problems.append(f"zero gradient at {zero[:8]}")
        if cfg.train_bn == "frozen" and bn_moved:
            problems.append(f"frozen BN moved: {bn_moved[:5]}")
        missing = [k for k in want if launches[k] == 0]
        extra = [k for k in never if launches[k]]
        if missing or extra:
            problems.append(f"launched {launches}: missing {missing}, "
                            f"unexpected {extra}")
        if cfg.train_remat_backbone and launches["stem"] != 2 * timed:
            problems.append(f"remat: K3 launched {launches['stem']} times "
                            f"in {timed} steps (expected twice a step)")
        if problems:
            raise AssertionError(f"train {name}: {problems}")
        del opt, params, data, m
        state = None
        torch.cuda.empty_cache()
    return by_path, per_step, grad_rows


def check_train_small(dev, seed):
    """One training step at the tiny config in float32 on the card and on
    the CPU, from the same params and draws, in both BN modes."""
    from maskrcnn_tpu_torch.core.anchors import generate_anchors
    from maskrcnn_tpu_torch.core.config import tiny_test_config
    from maskrcnn_tpu_torch.models import mask_rcnn as M
    from maskrcnn_tpu_torch.train.data import synthetic_train_batch
    from maskrcnn_tpu_torch.train import step as T
    out = {}
    for mode in ("batch", "frozen"):
        cfg = tiny_test_config().replace(compute_dtype="float32",
                                         train_bn=mode)
        gen = torch.Generator().manual_seed(seed)
        params = M.init_mask_rcnn(gen, cfg)
        live_bn(params, gen)
        data = synthetic_train_batch(cfg, 2, "cpu", seed=seed + 1, gt=4)
        anchors = torch.from_numpy(generate_anchors(cfg))
        draws = T.draw_uniforms(torch.Generator().manual_seed(seed), 2,
                                anchors.shape[0], cfg.max_proposals + 4,
                                "cpu")
        res = {}
        for where in ("cpu", dev):
            state, opt = T.make_train_state(M.params_to(params, where), cfg)
            new, m = T.train_step(
                state, {k: v.to(where) for k, v in data.items()}, anchors,
                cfg, opt, draws={k: v.to(where) for k, v in draws.items()})
            res[str(where)] = ({k: float(v) for k, v in m.items()},
                               new.params["conv1"]["kernel"].cpu())
        (l_cpu, k_cpu), (l_dev, k_dev) = res["cpu"], res[str(dev)]
        rel = {k: abs(l_dev[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-6)
               for k in l_cpu}
        out[mode] = {"losses_cpu": l_cpu, "losses_card": l_dev,
                     "max_rel_loss_err": max(rel.values()),
                     "conv1_after_step_max_abs_err":
                         (k_cpu - k_dev).abs().max().item()}
    # float32 layers summed in another order on the two devices (TF32
    # off); batch statistics amplify it through the layers
    tol = 2e-3
    emit({"phase": "train_small_vs_cpu", "tol": tol, **out})
    bad = [m for m, r in out.items() if not r["max_rel_loss_err"] <= tol]
    if bad:
        raise AssertionError(f"train step on the card disagrees with the "
                             f"CPU in {bad}")


# --------------------------------------------------------------------------
# serving, the CLI and the bench script on the card
# --------------------------------------------------------------------------

def synthetic_photo(rng, shape) -> np.ndarray:
    """A uint8 image of the given (H, W[, C]) shape: gradients, a few
    rectangles and noise, so JPEG and the detector see some structure."""
    h, w = shape[:2]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([xx * 255 / w, yy * 255 / h,
                    (xx + yy) * 127 / (h + w)], -1)
    for _ in range(6):
        y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
        img[y0:y0 + rng.integers(h // 8, h // 2),
            x0:x0 + rng.integers(w // 8, w // 2)] = rng.uniform(0, 255, 3)
    img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)
    if len(shape) == 2:
        return img.mean(-1).astype(np.uint8)
    if shape[2] == 4:
        return np.concatenate([img, np.full((h, w, 1), 200, np.uint8)], -1)
    return img


def encode_image(img: np.ndarray, fmt: str) -> bytes:
    import io
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format=fmt)
    return buf.getvalue()


def describe(cfg) -> str:
    return (f"{cfg.architecture} {cfg.image_height}x{cfg.image_width}x3, "
            f"{cfg.num_classes} classes, {cfg.compute_dtype}")


def random_detector(dev, seed, cfg):
    """A detector of `cfg` on `dev`, random weights from the seed with BN
    statistics drawn from it."""
    from maskrcnn_tpu_torch.models import mask_rcnn as M
    from maskrcnn_tpu_torch.pipeline.detector import MaskRCNNDetector
    gen = torch.Generator().manual_seed(seed)
    params = M.init_mask_rcnn(gen, cfg)
    live_bn(params, gen)
    return MaskRCNNDetector(cfg, params, device=dev)


# --------------------------------------------------------------------------
# The host native library
# --------------------------------------------------------------------------

def host_native() -> dict:
    """Which of the native library's parts the host paths run on."""
    from maskrcnn_tpu_torch import native
    imageio = native.get_imageio_lib()
    return {"rle": native.get_rle_lib() is not None,
            "evalmatch": native.get_evalmatch_lib() is not None,
            "imageio": imageio is not None,
            "imageio_jpeg": imageio is not None and imageio.has_jpeg}


class host_fallback:
    """Inside it every getter of the native library returns None: the
    PIL/numpy paths the callers take where the library did not build."""

    def __enter__(self):
        from maskrcnn_tpu_torch import native
        from maskrcnn_tpu_torch.evalkit import cocoeval, mask_rle
        from maskrcnn_tpu_torch.pipeline import loader
        self.saved = [(m, a, getattr(m, a)) for m, a in (
            (loader, "get_imageio_lib"), (native, "get_imageio_lib"),
            (mask_rle, "get_rle_lib"), (cocoeval, "get_evalmatch_lib"))]
        for m, a, _ in self.saved:
            setattr(m, a, lambda: None)

    def __exit__(self, *exc):
        for m, a, f in self.saved:
            setattr(m, a, f)


def host_ms(fn, reps: int = 3) -> tuple[float, object]:
    """Median host wall ms of `fn()` over `reps` calls after one warm-up,
    and its last result."""
    out = fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), out


def host_cpu() -> dict:
    """The host CPU as /proc/cpuinfo reports it, and the cores this
    process may run on."""
    import os
    info = {"nproc": len(os.sched_getaffinity(0))}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key = line.split(":")[0].strip()
            if key in ("model name", "vendor_id", "cpu family",
                       "model") and key not in info:
                info[key] = line.split(":", 1)[1].strip()
    return info


def random_boxes(rng, n, h, w):
    """`n` (y1, x1, y2, x2) pixel boxes of 8..min(h, w)/2 a side, partly
    outside the frame for some."""
    side = rng.uniform(8, min(h, w) / 2, (n, 2))
    y1 = rng.uniform(-20, h - 8, n)
    x1 = rng.uniform(-20, w - 8, n)
    return np.stack([y1, x1, y1 + side[:, 0], x1 + side[:, 1]], 1)


def match_dataset(rng, cases=400):
    """A seeded random COCO matching workload: `cases` (image, category)
    pairs of 1..100 detections against 1..20 gt, sparse IoUs, some crowd
    and ignored gt, areas across the small/medium/large ranges."""
    from maskrcnn_tpu_torch.evalkit.cocoeval import AREA_RNG
    rngs = np.asarray(list(AREA_RNG.values()))
    out = []
    for _ in range(cases):
        d, g = int(rng.integers(1, 101)), int(rng.integers(1, 21))
        ious = rng.uniform(0, 1, (d, g))
        ious[rng.random((d, g)) < 0.7] = 0.0
        out.append((ious, rng.uniform(0, 200 ** 2, g), rng.random(g) < 0.1,
                    rng.random(g) < 0.05, rng.uniform(0, 200 ** 2, d), rngs))
    return out


def native_phase(seed, size=1024, n_masks=100, image_hw=(768, 1024)):
    """The host native library on the card's machine (`maskrcnn_tpu_torch/
    native`, g++): which libraries built and why not, each native function
    against its PIL/numpy fallback within the JAX tests' budgets, and
    host ms of both at the serving path's sizes."""
    import os
    from maskrcnn_tpu_torch import native
    from maskrcnn_tpu_torch.evalkit import cocoeval, mask_rle
    from maskrcnn_tpu_torch.pipeline import detector, loader
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True)
    status = host_native()
    errors = native.native_errors()
    libs = {}
    for name, get in (("rle", native.get_rle_lib),
                      ("imageio", native.get_imageio_lib),
                      ("evalmatch", native.get_evalmatch_lib)):
        lib = get()
        libs[name] = None if lib is None else os.path.basename(lib._name)
    head = {"phase": "native", "host_native": status, "libraries": libs,
            "build_errors": errors,
            "gxx": (gxx.stdout or gxx.stderr).splitlines()[:1],
            "cpu": host_cpu(), "nvidia_smi": nvidia_smi_line()}
    missing = [k for k in ("rle", "evalmatch", "imageio") if not status[k]]
    if missing:
        emit(head)
        raise AssertionError(f"native libraries {missing} did not load: "
                             f"{errors}")

    rng = np.random.default_rng(seed + 9)
    checks, ms = {}, {}

    def both(name, fn):
        """`fn()` on the native path and on the fallback, timed."""
        nat_ms, nat = host_ms(fn)
        with host_fallback():
            fb_ms, fb = host_ms(fn)
        ms[name] = {"native_ms": nat_ms, "fallback_ms": fb_ms}
        return nat, fb

    # letterbox (<= 2 levels: tests/test_imageio.py)
    for h, w in ((480, 640), (1024, 768)):
        img = synthetic_photo(rng, (h, w, 3))
        (nc, nw), (fc, fw) = both(f"letterbox_{h}x{w}_to_{size}",
                                  lambda: loader.letterbox_rgb(img, size))
        checks[f"letterbox_{h}x{w}"] = {
            "max_abs_diff": float(np.abs(nc - fc).max()), "budget": 2.0,
            "windows_equal": nw == fw}
    # JPEG bytes -> decode (bit-exact where libjpeg is in) and letterbox
    img = synthetic_photo(rng, (480, 640, 3))
    jpeg = encode_image(img, "JPEG")
    nd, fd = both("decode_jpeg_bytes_480x640",
                  lambda: loader.decode_rgb_bytes(jpeg))
    (nc, nw), (fc, fw) = both(f"decode_letterbox_jpeg_bytes_480x640_to_"
                              f"{size}",
                              lambda: loader.load_letterboxed_bytes(jpeg,
                                                                    size))
    checks["decode_jpeg_bytes"] = {
        "max_abs_diff": int(np.abs(nd.astype(int) - fd).max()),
        "budget": 0 if status["imageio_jpeg"] else "PIL on both sides"}
    checks["decode_letterbox_jpeg_bytes"] = {
        "max_abs_diff": float(np.abs(nc - fc).max()), "budget": 2.0,
        "windows_equal": nw == fw}
    # 100 detections pasted into a serving-size image (flips < 2e-3 of the
    # image per detection: tests/test_imageio.py), then RLE
    ih, iw = image_hw
    soft = rng.uniform(0, 1, (n_masks, 28, 28)).astype(np.float32)
    boxes = random_boxes(rng, n_masks, ih, iw)

    def paste_all():
        return [detector.paste_mask_region(m, b, image_hw)
                for m, b in zip(soft, boxes)]

    nat, fb = both(f"paste_mask_region_x{n_masks}_{ih}x{iw}", paste_all)
    flips = [int((a[0] != b[0]).sum()) for a, b in zip(nat, fb)]
    checks["paste_mask_region"] = {
        "regions_same_place": all(a[1:] == b[1:] and a[0].shape == b[0].shape
                                  for a, b in zip(nat, fb)),
        "max_flip_share": max(flips) / (ih * iw), "budget": 2e-3,
        "flipped_pixels": sum(flips),
        "pasted_pixels": int(sum(a[0].sum() for a in nat))}
    encoded, _ = both(f"encode_region_x{n_masks}", lambda: [
        mask_rle.encode_region(r, y, x, ih, iw) for r, y, x in nat])
    strings, _ = both(f"to_coco_counts_x{n_masks}", lambda: [
        mask_rle.to_coco_counts(r) for r in encoded])
    full = [np.zeros(image_hw, np.uint8) for _ in range(20)]
    for m, (r, y, x) in zip(full, nat[:20]):
        m[y:y + r.shape[0], x:x + r.shape[1]] = r
    ne, fe = both("encode_full_canvas_x20", lambda: [mask_rle.encode(m)
                                                    for m in full])
    nd, fd = both("decode_x20", lambda: [mask_rle.decode(r) for r in ne])
    gt = ne
    crowd = (np.arange(len(gt)) % 7 == 0).astype(bool)
    ni, fi = both(f"iou_masks_{n_masks}x{len(gt)}",
                  lambda: mask_rle.iou_masks(encoded, gt, crowd))
    bd = np.concatenate([boxes[:, 1::-1], boxes[:, 3:1:-1]
                         - boxes[:, 1::-1]], 1)
    nb, fbx = both(f"iou_boxes_{n_masks}x{len(gt)}",
                   lambda: mask_rle.iou_boxes(bd, bd[:len(gt)], crowd))
    checks["rle"] = {
        "encode_equal": all(np.array_equal(a.counts, b.counts)
                            for a, b in zip(ne, fe)),
        "encode_region_equals_encode": all(
            np.array_equal(a.counts, b.counts)
            for a, b in zip(encoded[:20], ne)),
        "decode_equal": all(np.array_equal(a, b) for a, b in zip(nd, fd)),
        "decode_round_trip": all(np.array_equal(a, m)
                                 for a, m in zip(nd, full)),
        "iou_masks_equal": bool(np.array_equal(ni, fi)),
        # float64 arithmetic: g++ contracts `a + b - x * y` into one FMA
        # under -march=native and numpy does not, so the two may differ in
        # the last bit; the port's native bits equal the JAX package's
        # (tests/test_torch_native.py)
        "iou_boxes_max_abs_diff": float(np.abs(nb - fbx).max()),
        "iou_boxes_budget": 1e-12,
        "counts_chars": sum(len(s) for s in strings)}
    cases = match_dataset(rng)
    nm, fm = both(f"match_all_areas_{len(cases)}_cases", lambda: [
        cocoeval.match_all_areas(*c) for c in cases])
    checks["match_all_areas"] = {
        "cases": len(cases), "detections": sum(c[0].shape[0]
                                               for c in cases),
        "equal": all(np.array_equal(a[k], b[k]) for a, b in zip(nm, fm)
                     for k in ("dtm", "d_ignore", "n_gt")),
        "matched": int(sum((a["dtm"] >= 0).sum() for a in nm))}
    head.update({"checks": checks, "host_ms": ms,
                 "reps": "median of 3 after 1 warm-up",
                 # numpy/Python in both packages: no native variant
                 "no_native_path": [f"encode_region_x{n_masks}",
                                    f"to_coco_counts_x{n_masks}"]})
    emit(head)
    bad = [k for k in ("letterbox_480x640", "letterbox_1024x768",
                       "decode_letterbox_jpeg_bytes")
           if not (checks[k]["max_abs_diff"] <= 2.0
                   and checks[k]["windows_equal"])]
    if status["imageio_jpeg"] and checks["decode_jpeg_bytes"][
            "max_abs_diff"] != 0:
        bad.append("decode_jpeg_bytes")
    p = checks["paste_mask_region"]
    if not (p["regions_same_place"] and p["max_flip_share"] < 2e-3):
        bad.append("paste_mask_region")
    bad += [f"rle {k}" for k, v in checks["rle"].items() if v is False]
    if not checks["rle"]["iou_boxes_max_abs_diff"] <= 1e-12:
        bad.append("rle iou_boxes")
    if not checks["match_all_areas"]["equal"]:
        bad.append("match_all_areas")
    if bad:
        raise AssertionError(f"native against fallback: {bad}")


# the request bodies: mixed sizes, JPEG and PNG, one grayscale, one RGBA
SERVE_BODIES = (((480, 640, 3), "JPEG"), ((640, 480, 3), "PNG"),
                ((768, 1024, 3), "JPEG"), ((300, 500, 3), "PNG"),
                ((480, 640), "JPEG"), ((640, 480, 4), "PNG"),
                ((1024, 768, 3), "JPEG"), ((500, 300, 3), "JPEG"))
SERVE_KERNELS = ("nms", "roi_align", "stem", "bottleneck")


def serve(dev, seed, batch, base, rounds=2):
    """`pipeline/serve.make_server` on a thread, `base` config (the default
    one: unfused heads) at score threshold 0: 8 concurrent POST /detect
    from 8 threads, `rounds` times over, then one malformed body."""
    import contextlib
    import threading
    import urllib.error
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor
    from maskrcnn_tpu_torch.evalkit import mask_rle
    from maskrcnn_tpu_torch.ops import cuda_lib
    from maskrcnn_tpu_torch.pipeline.serve import make_server
    det = random_detector(dev, seed,
                          base.replace(detection_score_threshold=0.0))
    rng = np.random.default_rng(seed + 2)
    images = [synthetic_photo(rng, s) for s, _ in SERVE_BODIES]
    bodies = [encode_image(im, fmt) for im, (_, fmt) in zip(images,
                                                             SERVE_BODIES)]
    det.detect_images(images[:batch], paste_masks="rle", batch_size=batch,
                      uint8_wire=True)                         # warm-up
    server, worker = make_server(det, port=0, max_batch=batch,
                                 window_ms=20.0, uint8_wire=True)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]

    def post(data):
        req = urllib.request.Request(f"http://{host}:{port}/detect",
                                     data=data, method="POST")
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                code, body = r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            code, body = e.code, json.loads(e.read())
        return code, body, (time.perf_counter() - t0) * 1e3

    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        replies = []
        for _ in range(rounds):
            with ThreadPoolExecutor(len(bodies)) as pool:
                replies += list(pool.map(post, bodies))
        wall = time.perf_counter() - t0
        launches = dict(cuda_lib.launches)                     # main path
        peak = torch.cuda.max_memory_allocated()
        forwards, frames = worker.batches, worker.frames
        batch_counts = dict(worker.batch_size_counts)
        # the same traffic on the native host path and on its PIL/numpy
        # fallback in turns (fallback, native, native, fallback), `rounds`
        # rounds each: what the native library moves end to end
        host_ab = {"native": [], "fallback": []}
        for arm in ("fallback", "native", "native", "fallback"):
            with host_fallback() if arm == "fallback" else \
                    contextlib.nullcontext():
                t1 = time.perf_counter()
                got = []
                for _ in range(rounds):
                    with ThreadPoolExecutor(len(bodies)) as pool:
                        got += list(pool.map(post, bodies))
                host_ab[arm].append({
                    "requests_per_s": len(got) / (time.perf_counter() - t1),
                    "latency_ms_p50": float(np.median([g[2] for g in got])),
                    "ok": all(g[0] == 200 for g in got)})
        bad_code, bad_body, _ = post(b"this is not an image")
        with urllib.request.urlopen(f"http://{host}:{port}/healthz",
                                    timeout=60) as r:
            health = json.loads(r.read())
    finally:
        server.shutdown()
        worker.stop()
        server.server_close()
        thread.join(timeout=30)

    errors, n_dets = [], []
    for i, (code, body, _) in enumerate(replies):
        shape = SERVE_BODIES[i % len(SERVE_BODIES)][0]
        h, w = shape[:2]
        if code != 200:
            errors.append(f"request {i} {shape}: {code} {body}")
            continue
        n_dets.append(len(body["detections"]))
        for d in body["detections"]:
            y1, x1, y2, x2 = d["box_yxyx"]
            if not (0 <= y1 <= y2 <= h and 0 <= x1 <= x2 <= w):
                errors.append(f"request {i}: box {d['box_yxyx']} outside "
                              f"{h}x{w}")
            rle = d["mask_rle"]
            m = mask_rle.decode(mask_rle.from_coco_counts(
                rle["counts"], *rle["size"]))
            if m.shape != (h, w):
                errors.append(f"request {i}: mask {m.shape} for {h}x{w}")
    lat = np.asarray([ms for _, _, ms in replies])
    emit({"phase": "serve", "config": describe(det.config)
          + ", unfused heads, score threshold 0, uint8_wire",
          "requests": len(replies), "clients": len(bodies),
          "max_batch": batch, "window_ms": 20.0, "wall_s": wall,
          "requests_per_s": len(replies) / wall,
          "latency_ms_p50": float(np.percentile(lat, 50)),
          "latency_ms_p95": float(np.percentile(lat, 95)),
          "server_latency_ms_p50": float(np.median(
              [b["latency_ms"] for c, b, _ in replies if c == 200] or [0])),
          "batch_size_counts": batch_counts,
          "forwards": forwards, "launches": launches,
          "detections_per_reply": n_dets, "healthz": health,
          "malformed": [bad_code, bad_body],
          "device": str(det.device), "host_native": host_native(),
          "host_native_vs_fallback": host_ab,
          "max_memory_allocated_bytes": peak})
    if not all(r["ok"] for arm in host_ab.values() for r in arm):
        errors.append(f"a reply of the native/fallback turns failed: "
                      f"{host_ab}")
    if errors:
        raise AssertionError(f"serve: {errors[:5]}")
    if bad_code != 500:
        raise AssertionError(f"malformed request answered {bad_code}")
    if det.device.type != "cuda":
        raise AssertionError(f"served on {det.device}")
    if not any(n > 1 for n in batch_counts):
        raise AssertionError("no batch of more than one request formed: "
                             f"{batch_counts}")
    if health["frames"] != worker.frames or frames != len(replies):
        raise AssertionError(f"healthz counted {health['frames']} frames "
                             f"for {len(replies)} requests")
    if launches["stem"] != forwards or launches["nms"] != 2 * forwards:
        raise AssertionError(f"{forwards} forwards launched K3 "
                             f"{launches['stem']} and K1 {launches['nms']} "
                             "times (expected once and twice per forward)")
    missing = [k for k in SERVE_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"serve path never launched {missing}")
    return launches


SERVE_PROBE_CLIENTS = (1, 4)
SERVE_PROBE_MAX_BATCH = 8     # the detector pads every forward to this


def serve_probe_phase(dev, seed, base, requests=16, warmup=16,
                      max_batch=SERVE_PROBE_MAX_BATCH):
    """`maskrcnn_tpu_torch/tools/serve_probe.py` on the card: `base` (the
    default config) at score threshold 0 from a config JSON, random weights
    from the seed, uint8 wire, max batch 8, K = 1 and 4 at `requests` each
    after a warm-up round of `warmup` requests at K = 1."""
    import contextlib
    import io
    import os
    import tempfile
    from maskrcnn_tpu_torch.ops import cuda_lib
    from maskrcnn_tpu_torch.tools import serve_probe
    with tempfile.TemporaryDirectory() as d:
        cfg, out = os.path.join(d, "config.json"), os.path.join(d, "out.json")
        base.replace(detection_score_threshold=0.0).to_json(cfg)
        buf = io.StringIO()
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = serve_probe.main([
                "--config", cfg, "--seed", str(seed), "--port", "0",
                "--max-batch", str(max_batch), "--requests", str(requests),
                "--warmup-requests", str(warmup), "--out", out,
                "--clients", *map(str, SERVE_PROBE_CLIENTS)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(cuda_lib.launches)                     # main path
        with open(out) as f:
            report = json.load(f)
    emit({"phase": "serve_probe", "config": describe(base)
          + ", unfused heads, score threshold 0, uint8_wire",
          "rc": rc, "seconds": seconds, "launches": launches,
          "host_native": host_native(), "report": report})
    if rc != 0:
        raise AssertionError(f"serve_probe exited {rc}")
    points = [report["warmup"]] + report["sweep"]
    if [p["clients"] for p in report["sweep"]] != list(SERVE_PROBE_CLIENTS):
        raise AssertionError(f"serve_probe swept {report['sweep']}")
    batches = 0
    for p, n in zip(points, [warmup] + [requests] * len(report["sweep"])):
        hist = {int(k): c for k, c in p["batch_size_hist"].items()}
        if p["requests"] != n or sum(k * c for k, c in hist.items()) != n:
            raise AssertionError(f"serve_probe point {p}: its histogram "
                                 f"does not hold its {n} requests")
        batches += sum(hist.values())
    forwards = batches + 1                     # + the tool's warm-up batch
    if launches["stem"] != forwards or launches["nms"] != 2 * forwards:
        raise AssertionError(f"{forwards} forwards launched K3 "
                             f"{launches['stem']} and K1 {launches['nms']} "
                             "times (expected once and twice per forward)")
    missing = [k for k in SERVE_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"serve_probe path never launched {missing}")
    return launches


def evaluate_bench(images=500, dets=20):
    """Host only: `tools/bench_cocoeval.py` at `images` images in bbox and
    segm, native matcher and `--numpy` (equal AP and AR100 demanded), and
    `tools/bench_results_leg.py` at `images` x `dets` in both modes (the
    same RLE rows from both, checked at 50 images)."""
    import contextlib
    import io
    import os
    import tempfile
    from maskrcnn_tpu_torch.tools import bench_cocoeval, bench_results_leg

    def run(tool, argv, path):
        with contextlib.redirect_stdout(io.StringIO()):
            rc = tool.main(argv + ["--json", path])
        if rc != 0:
            raise AssertionError(f"{tool.__name__} {argv} exited {rc}")
        with open(path) as f:
            return json.load(f)

    cocoeval, leg = {}, {}
    with tempfile.TemporaryDirectory() as d:
        for iou in ("bbox", "segm"):
            for flags in ([], ["--numpy"]):
                key = f"{iou}_{'numpy' if flags else 'native'}"
                cocoeval[key] = run(bench_cocoeval, [
                    "--images", str(images), "--iou-type", iou] + flags,
                    os.path.join(d, key + ".json"))
        for flags in ([], ["--full-canvas"]):
            key = "full_canvas" if flags else "region_rle"
            leg[key] = run(bench_results_leg, [
                "--images", str(images), "--dets", str(dets)] + flags,
                os.path.join(d, key + ".json"))
    ds, raw = bench_results_leg.synth(50, dets)
    same_rows = (bench_results_leg.results_rows(ds, raw, False)[0]
                 == bench_results_leg.results_rows(ds, raw, True)[0])
    emit({"phase": "evaluate_bench", "host_native": host_native(),
          "host": host_cpu(), "cocoeval": cocoeval, "results_leg": leg,
          "results_leg_rows_equal_across_modes": same_rows})
    def ap_ar(key):
        return cocoeval[key]["ap"], cocoeval[key]["ar100"]

    bad = [iou for iou in ("bbox", "segm")
           if ap_ar(f"{iou}_native") != ap_ar(f"{iou}_numpy")]
    if bad:
        raise AssertionError(f"native and numpy matchers disagree: {bad}")
    if not all(0 < r["ap"] < 1 for r in cocoeval.values()):
        raise AssertionError(f"cocoeval AP out of (0, 1): {cocoeval}")
    if not same_rows:
        raise AssertionError("the results leg's two modes disagree")


def ap_table(text: str) -> dict:
    """The 12-number summaries the evaluate CLI printed, by IoU type."""
    out = {}
    for m in re.finditer(r"\[(bbox|segm)\] (.+?)\s+= (-?[0-9.]+)", text):
        out.setdefault(m.group(1), []).append(float(m.group(3)))
    return out


def cli(dev, seed, batch, base):
    """`maskrcnn_tpu_torch.cli.main` in-process over a temporary COCO
    workspace, `base` config at score threshold 0: evaluate (K1-K4), demo,
    and stream with both fused heads (K5 and K6 once per forward); then
    train on synthetic data, and resume it."""
    import contextlib
    import io
    import os
    import shutil
    import tempfile
    from PIL import Image
    from maskrcnn_tpu_torch.cli.main import main as cli_main
    from maskrcnn_tpu_torch.core.coco_names import COCO_CATEGORY_IDS, \
        COCO_CLASS_NAMES
    from maskrcnn_tpu_torch.evalkit import mask_rle
    from maskrcnn_tpu_torch.io.weights import (load_npz_checkpoint,
                                               save_npz_checkpoint)
    from maskrcnn_tpu_torch.models import mask_rcnn as M
    from maskrcnn_tpu_torch.ops import cuda_lib

    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        images_dir = os.path.join(root, "coco", "val2017")
        frames_dir = os.path.join(root, "frames")
        os.makedirs(images_dir)
        os.makedirs(frames_dir)
        rng = np.random.default_rng(seed + 3)
        shapes = ((480, 640, 3), (640, 480, 3), (600, 800, 3),
                  (427, 640, 3))
        images, anns = [], []
        for i, shape in enumerate(shapes, 1):
            img = synthetic_photo(rng, shape)
            h, w = shape[:2]
            name = f"{i:012d}.jpg"
            Image.fromarray(img).save(os.path.join(images_dir, name))
            images.append({"id": i, "width": w, "height": h,
                           "file_name": name})
            x, y = w * 0.2, h * 0.25
            bw, bh = w * 0.4, h * 0.5
            anns.append({"id": i, "image_id": i,
                         "category_id": int(COCO_CATEGORY_IDS[i]),
                         "bbox": [x, y, bw, bh], "area": bw * bh,
                         "iscrowd": 0,
                         "segmentation": [[x, y, x + bw, y, x + bw / 2,
                                           y + bh]]})
        cats = [{"id": int(c), "name": n} for c, n in
                zip(COCO_CATEGORY_IDS[1:], COCO_CLASS_NAMES[1:])]
        with open(os.path.join(root, "coco", "instances_val2017.json"),
                  "w") as f:
            json.dump({"images": images, "annotations": anns,
                       "categories": cats}, f)
        frame = synthetic_photo(rng, (768, 1024, 3))
        for i in range(8):
            Image.fromarray(np.roll(frame, 7 * i, axis=1)).save(
                os.path.join(frames_dir, f"{i:03d}.jpg"))
        cfg = base.replace(detection_score_threshold=0.0)
        fused = cfg.replace(fuse_classifier_head=True, fuse_mask_head=True)
        cfg_path = os.path.join(root, "config.json")
        fused_path = os.path.join(root, "config_fused.json")
        cfg.to_json(cfg_path)
        fused.to_json(fused_path)
        gen = torch.Generator().manual_seed(seed)
        params = M.init_mask_rcnn(gen, cfg)
        live_bn(params, gen)
        weights = os.path.join(root, "checkpoint.npz")
        save_npz_checkpoint(params, weights)
        del params
        # on the card the CLI's default device (no --device) is the card
        on = [] if dev.type == "cuda" else ["--device", str(dev)]
        model = ["--config", cfg_path, "--weights", weights] + on
        results = os.path.join(root, "results")

        def run(argv):
            buf = io.StringIO()
            torch.cuda.synchronize()
            cuda_lib.reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli_main(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = dict(cuda_lib.launches)
            if rc != 0:
                raise AssertionError(f"cli {argv[0]} exited {rc}:\n"
                                     f"{buf.getvalue()[-2000:]}")
            return buf.getvalue(), launches, seconds

        out, l_eval, s_eval = run(
            ["evaluate", "smoke", "coco", "--limit", "4", "--batch",
             str(batch), "--uint8", "--annotations_dir",
             os.path.join(root, "coco"), "--images_dir", images_dir,
             "--results_dir", results] + model)
        stats = ap_table(out)
        with open(os.path.join(results, "results.json")) as f:
            rows = json.load(f)
        sizes = {im["id"]: [im["height"], im["width"]] for im in images}
        bad_rows = [r["image_id"] for r in rows
                    if r["segmentation"]["size"] != sizes[r["image_id"]]
                    or mask_rle.decode(mask_rle.from_coco_segmentation(
                        r["segmentation"], *sizes[r["image_id"]])).shape
                    != tuple(sizes[r["image_id"]])]
        pb_bytes = os.path.getsize(os.path.join(results, "results.pb"))

        demo_png = os.path.join(root, "demo.png")
        out_demo, l_demo, s_demo = run(
            ["demo", "smoke", os.path.join(images_dir, images[0]["file_name"]),
             "-o", demo_png] + model)
        with Image.open(demo_png) as im:
            demo_size = [im.size[1], im.size[0]]

        stream_json = os.path.join(root, "stream.json")
        out_stream, l_stream, s_stream = run(
            ["stream", "smoke", "--frames-dir", frames_dir, "--micro-batch",
             str(batch), "--device-paste", "--json", stream_json,
             "--config", fused_path, "--weights", weights] + on)
        with open(stream_json) as f:
            stream_stats = json.load(f)

        # train: a synthetic overfit run (R50 @ 128^2, as the JAX CLI's
        # --synthetic) with a state file and a calibrated .npz, then
        # --resume to the total step
        state_path = os.path.join(root, "train_state.pt")
        npz_path = os.path.join(root, "trained.npz")
        train_argv = ["train", "smoke", "--synthetic", "--seed", str(seed),
                      "--batch", str(batch), "--log-every", "1",
                      "--state", state_path] + on
        out_train, l_train, s_train = run(
            train_argv + ["--steps", "3", "--output", npz_path,
                          "--calibrate-batches", "2"])
        out_resume, l_resume, s_resume = run(
            train_argv + ["--steps", "5", "--resume", "--no-calibrate"])
        trained = load_npz_checkpoint(npz_path)
        state_step = torch.load(state_path, weights_only=True)["step"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "cli", "config": describe(cfg)
          + ", score threshold 0; stream with both fused heads",
          "evaluate": {"seconds": s_eval, "launches": l_eval,
                       "rows": len(rows), "results_pb_bytes": pb_bytes,
                       "stats": stats},
          "demo": {"seconds": s_demo, "launches": l_demo,
                   "png_hw": demo_size, "stdout": out_demo.splitlines()[:1]},
          "stream": {"seconds": s_stream, "launches": l_stream,
                     "stats": stream_stats},
          "train": {"seconds": s_train, "launches": l_train,
                    "stdout": out_train.splitlines()[-6:]},
          "train_resume": {"seconds": s_resume, "launches": l_resume,
                           "stdout": out_resume.splitlines()[-4:],
                           "state_step": state_step},
          "host_native": host_native()})
    problems = []
    if "train state saved" not in out_train or "BN statistics calibrated" \
            not in out_train or not np.abs(
                trained["bn_conv1"]["moving_mean"]).sum() > 0:
        problems.append(f"train: {out_train[-500:]}")
    if "resumed from" not in out_resume or state_step != 5:
        problems.append(f"train --resume ended at step {state_step}: "
                        f"{out_resume[-500:]}")
    for what, launched in (("train", l_train), ("train --resume", l_resume)):
        if not (launched["nms"] and launched["roi_align"]):
            problems.append(f"{what} launched {launched}: no K1 or K2")
    if [len(stats.get(t, [])) for t in ("bbox", "segm")] != [12, 12]:
        problems.append(f"evaluate printed {stats}")
    if len(rows) != 4 * cfg.max_detections or bad_rows:
        problems.append(f"{len(rows)} rows, segmentation size wrong for "
                        f"{bad_rows[:5]}")
    if demo_size != sizes[1]:
        problems.append(f"demo png {demo_size} for {sizes[1]}")
    missing = [k for k in SERVE_KERNELS if l_eval[k] == 0]
    if missing:
        problems.append(f"evaluate never launched {missing}")
    if not (l_stream["roi_classifier_head"] == l_stream["roi_mask_head"]
            == l_stream["stem"] > 0) or l_stream["roi_align"]:
        problems.append(f"stream launches {l_stream}: K5 and K6 not once "
                        "per forward")
    if stream_stats["frames"] != 8:
        problems.append(f"stream ran {stream_stats['frames']} frames")
    if problems:
        raise AssertionError(f"cli: {problems}")
    return {"cli_evaluate": l_eval, "cli_stream": l_stream,
            "cli_train": l_train}


# --------------------------------------------------------------------------
# The accuracy loop: train from scratch, resume, evaluate in both numerics
# --------------------------------------------------------------------------

PROOF_TRAIN_KERNELS = ("nms", "roi_align")


def proof(dev, seed, batch, base):
    """`tools/flagship_proof.py`'s loop at full width and small depth: its
    synthetic COCO set (4 train and 2 val images at `base`'s size, drawn
    from the seed), `cli train` for 20 steps at --batch with a checkpoint
    every 10, then `--resume --steps 30` (must start at step 20), both
    calibrating the BN statistics; `cli evaluate` on the 2 val images in
    production and exact numerics (TF32 off), scored by the tool's `score`
    and `cross_mode_deltas`; `evaluate --compare-tf` (exit 2 naming
    TensorFlow where TF is absent, else on one image). AP is printed, not
    judged: 30 steps are too few."""
    import contextlib
    import io
    import math
    import os
    import shutil
    import tempfile
    from maskrcnn_tpu_torch.cli.main import main as cli_main
    from maskrcnn_tpu_torch.tools import flagship_proof as fp

    root = tempfile.mkdtemp(prefix="chip_smoke_proof_")
    try:
        t0 = time.perf_counter()
        ann_dir = fp.make_dataset(root, 4, 2, base.image_height, seed)
        data_s = time.perf_counter() - t0
        cfg_prod = os.path.join(root, "config_production.json")
        cfg_exact = os.path.join(root, "config_exact.json")
        base.to_json(cfg_prod)
        fp.exact_config(base).to_json(cfg_exact)
        on = [] if dev.type == "cuda" else ["--device", str(dev)]
        ckpt = os.path.join(root, "checkpoint.npz")
        ckpt_dir = os.path.join(root, "ckpts")
        metrics = os.path.join(root, "metrics.jsonl")

        def run(argv, exact=False):
            out, err = io.StringIO(), io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc, launches, peak = fp.run_counted(cli_main, argv, dev,
                                                    exact=exact)
            return {"rc": rc, "seconds": time.perf_counter() - t0,
                    "launches": launches, "peak_gb": peak,
                    "out": out.getvalue(), "err": err.getvalue()}

        train_argv = [
            "train", "proof", "--config", cfg_prod,
            "--annotations", os.path.join(ann_dir, "instances_train2017.json"),
            "--images_dir", os.path.join(ann_dir, "train2017"),
            "--batch", str(batch), "--seed", str(seed), "--log-every", "1",
            "--output", ckpt, "--cache-images", "8",
            "--checkpoint-dir", ckpt_dir, "--checkpoint-every", "10",
            "--calibrate-batches", "2", "--metrics-log", metrics] + on
        tr = run(train_argv + ["--steps", "20"])
        tr_resume = run(train_argv + ["--steps", "30", "--resume"])
        with open(metrics) as f:
            log = [json.loads(line) for line in f]

        evals = {}
        for mode, cfg in (("production", cfg_prod), ("exact_fp32",
                                                     cfg_exact)):
            res_dir = os.path.join(root, f"results_{mode}")
            argv = ["evaluate", "proof", "coco", "--limit", "2",
                    "--batch", str(batch), "--config", cfg,
                    "--weights", ckpt, "--annotations_dir", ann_dir,
                    "--images_dir", os.path.join(ann_dir, "val2017"),
                    "--results_dir", res_dir] + on
            ev = run(argv, exact=mode == "exact_fp32")
            if ev["rc"] == 0:
                with open(os.path.join(res_dir, "results.json")) as f:
                    ev["rows"] = len(json.load(f))
                ev["stats"] = fp.score(
                    root, os.path.join(res_dir, "results.json"), 2)
            evals[mode] = ev
        deltas = (fp.cross_mode_deltas(root, {
            m: os.path.join(root, f"results_{m}", "results.json")
            for m in evals}, 2) if all(e["rc"] == 0 for e in evals.values())
            else None)

        try:
            import tensorflow  # noqa: F401
            has_tf = True
        except ImportError:
            has_tf = False
        tf_run = run(["evaluate", "proof", "coco", "--limit", "1",
                      "--config", cfg_exact, "--weights", ckpt,
                      "--annotations_dir", ann_dir,
                      "--images_dir", os.path.join(ann_dir, "val2017"),
                      "--results_dir", os.path.join(root, "results_tf"),
                      "--compare-tf"] + on)
        tf_written = os.path.exists(os.path.join(root, "results_tf",
                                                 "results_tf.json"))
    finally:
        shutil.rmtree(root, ignore_errors=True)

    def brief(r):
        return {k: r[k] for k in ("rc", "seconds", "launches", "peak_gb",
                                  "rows", "stats") if k in r}

    emit({"phase": "proof", "config": describe(base)
          + f", batch {batch}, 4 train / 2 val synthetic images",
          "dataset_seconds": data_s,
          "train": dict(brief(tr), stdout=tr["out"].splitlines()[-4:]),
          "train_resume": dict(brief(tr_resume),
                               stdout=tr_resume["out"].splitlines()[:2]
                               + tr_resume["out"].splitlines()[-3:]),
          "loss_first_last": [log[0]["loss"], log[-1]["loss"]] if log
          else None,
          "production": brief(evals["production"]),
          "exact_fp32": brief(evals["exact_fp32"]),
          "exact_fp32_launches": evals["exact_fp32"]["launches"],
          "cross_mode_deltas": deltas,
          "compare_tf": {"tensorflow": has_tf, "rc": tf_run["rc"],
                         "results_tf_written": tf_written,
                         "stderr": tf_run["err"].strip().splitlines()[-1:]}})
    problems = []
    for what, r in (("train", tr), ("train --resume", tr_resume)):
        if r["rc"] != 0:
            problems.append(f"{what} exited {r['rc']}: {r['err'][-800:]}")
        missing = [k for k in PROOF_TRAIN_KERNELS if not r["launches"][k]]
        if missing:
            problems.append(f"{what} never launched {missing}")
        if "BN statistics calibrated" not in r["out"]:
            problems.append(f"{what} did not calibrate")
    if f"resumed from {ckpt_dir} at step 20" not in tr_resume["out"]:
        problems.append(f"resume did not start at step 20: "
                        f"{tr_resume['out'][:500]}")
    if [r["step"] for r in log] != list(range(30)):
        problems.append(f"logged steps {[r['step'] for r in log]}")
    bad = [(r["step"], k) for r in log for k, v in r.items()
           if k != "step" and not math.isfinite(v)]
    if bad:
        problems.append(f"non-finite losses {bad[:5]}")
    for mode, ev in evals.items():
        if ev["rc"] != 0:
            problems.append(f"evaluate {mode} exited {ev['rc']}: "
                            f"{ev['err'][-800:]}")
    missing = [k for k in SERVE_KERNELS
               if not evals["production"]["launches"][k]]
    if missing:
        problems.append(f"production evaluate never launched {missing}")
    if has_tf:
        if tf_run["rc"] != 0 or not tf_written:
            problems.append(f"--compare-tf exited {tf_run['rc']}")
    elif tf_run["rc"] != 2 or "TensorFlow" not in tf_run["err"]:
        problems.append(f"--compare-tf without TF exited {tf_run['rc']}: "
                        f"{tf_run['err'][-300:]}")
    if problems:
        raise AssertionError(f"proof: {problems}")
    return {"proof_train": tr["launches"],
            "proof_train_resume": tr_resume["launches"],
            "proof_evaluate": evals["production"]["launches"],
            "proof_evaluate_exact": evals["exact_fp32"]["launches"]}


# --------------------------------------------------------------------------
# MobileNetV2-FPN, export, data parallel
# --------------------------------------------------------------------------

MNV2_KERNELS = ("nms", "roi_align")
RESNET_ONLY = ("stem", "bottleneck")


def mnv2(dev, seed, batch, base, frames=8, timed_steps=3):
    """MobileNetV2-FPN @ 1024^2, 81 classes, bf16, random weights from the
    seed with live BN: `detect_images` over the e2e images at the default
    and the zero score threshold (K1, K2; never K3 or K4, ResNet's), the
    forward's time and profile, `run_stream` with both fused heads over
    `frames` frames (K5 and K6 once a forward), and batch-BN `train_step`
    (1 warm-up, `timed_steps` timed). Each of the three runs is a main
    path: counts zeroed just before, read just after."""
    from maskrcnn_tpu_torch.core.anchors import generate_anchors
    from maskrcnn_tpu_torch.models import mask_rcnn as M
    from maskrcnn_tpu_torch.ops import cuda_lib
    from maskrcnn_tpu_torch.pipeline.detector import MaskRCNNDetector
    from maskrcnn_tpu_torch.pipeline.stream import (run_stream,
                                                    synthetic_frames)
    from maskrcnn_tpu_torch.train import step as T
    from maskrcnn_tpu_torch.train.data import synthetic_train_batch
    cfg = base.replace(architecture="mobilenetv2")
    gen = torch.Generator().manual_seed(seed)
    params = M.init_mask_rcnn(gen, cfg)
    live_bn(params, gen)
    det = MaskRCNNDetector(cfg, params, device=dev)
    low = MaskRCNNDetector(cfg.replace(detection_score_threshold=0.0),
                           det.params, device=dev)
    images = e2e_images(np.random.default_rng(seed))
    det.detect_images(images[:batch], batch_size=batch)        # warm-up
    cuda_lib.reset_launches()
    res_default, ms_default = timed_detect(det, images, batch)
    launches_default = dict(cuda_lib.launches)
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    res_low, ms_low = timed_detect(low, images, batch)         # main path
    launches = dict(cuda_lib.launches)
    peak = torch.cuda.max_memory_allocated()
    size = cfg.image_height
    canvases = torch.from_numpy(np.random.default_rng(seed).uniform(
        0, 255, (batch, size, size, 3)).astype(np.float32))
    lat = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = low.run_batch(canvases)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    profile = profile_forward(low, canvases)
    finite = all(bool(torch.isfinite(out[k].float()).all())
                 for k in ("detections", "masks", "rois"))
    n_low = [len(r) for r in res_low]

    fused = MaskRCNNDetector(cfg.replace(
        fuse_classifier_head=True, fuse_mask_head=True,
        detection_score_threshold=0.0), det.params, device=dev)
    fused.run_batch(np.stack(list(synthetic_frames(batch, size, seed + 1))),
                    paste_size=size)                           # warm-up
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    stats = run_stream(fused, synthetic_frames(frames, size, seed),
                       micro_batch=batch, paste_size=size,
                       latency_probes=2, sync_every=4)         # main path
    torch.cuda.synchronize()
    launches_stream = dict(cuda_lib.launches)
    forwards = -(-frames // batch) + stats.latency_probes
    del fused, det

    tcfg = cfg                                   # train_bn "batch" default
    state, opt = T.make_train_state(low.params, tcfg)
    data = synthetic_train_batch(tcfg, batch, dev, seed=seed + 1)
    anchors = torch.from_numpy(generate_anchors(tcfg)).to(dev)
    state, _ = T.train_step(state, data, anchors, tcfg, opt, seed=seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    times, losses = [], []
    for _ in range(timed_steps):                               # main path
        t0 = time.perf_counter()
        state, m = T.train_step(state, data, anchors, tcfg, opt, seed=seed)
        losses.append({k: float(v) for k, v in m.items()})
        times.append((time.perf_counter() - t0) * 1e3)
    launches_train = dict(cuda_lib.launches)
    train_peak = torch.cuda.max_memory_allocated()
    del state, opt, data
    emit({"phase": "mnv2", "config": describe(cfg), "batch_size": batch,
          "detect_images_ms": {"default_thresholds": ms_default,
                               "score_threshold_0": ms_low},
          "forward_batch_ms": lat,
          "detections_default": [len(r) for r in res_default],
          "detections_score_threshold_0": n_low,
          "max_memory_allocated_bytes": peak, "finite": finite,
          "profile": profile, "launches_default": launches_default,
          "launches": launches,
          "stream": {"frames": stats.frames, "fps": stats.fps,
                     "p50_latency_ms": stats.p50_latency_ms,
                     "p95_latency_ms": stats.p95_latency_ms,
                     "forwards": forwards, "launches": launches_stream},
          "train_batch_bn": {"step_ms": times,
                             "step_ms_p50": float(np.median(times)),
                             "images_per_s": batch / np.median(times) * 1e3,
                             "max_memory_allocated_bytes": train_peak,
                             "losses_last": losses[-1],
                             "launches_per_step": {
                                 k: v / timed_steps
                                 for k, v in launches_train.items()}}})
    problems = []
    if not finite or min(n_low) != cfg.max_detections:
        problems.append(f"finite {finite}, detections {n_low}")
    for name, got, want, never in (
            ("detect", launches, MNV2_KERNELS, RESNET_ONLY),
            ("stream", launches_stream,
             ("nms", "roi_classifier_head", "roi_mask_head"),
             RESNET_ONLY + ("roi_align",)),
            ("train", launches_train, MNV2_KERNELS, RESNET_ONLY)):
        missing = [k for k in want if got[k] == 0]
        extra = [k for k in never if got[k]]
        if missing or extra:
            problems.append(f"{name} launched {got}: missing {missing}, "
                            f"unexpected {extra}")
    for k in ("roi_classifier_head", "roi_mask_head"):
        if launches_stream[k] != forwards:
            problems.append(f"{k} launched {launches_stream[k]} times in "
                            f"{forwards} forwards")
    if not all(np.isfinite(v) for row in losses for v in row.values()):
        problems.append(f"non-finite training loss {losses}")
    if problems:
        raise AssertionError(f"mnv2: {problems}")
    return {"mnv2": launches, "mnv2_stream": launches_stream,
            "mnv2_train": launches_train}


EXPORT_TOL = 1e-4
EXPORT_KERNELS = ("nms", "roi_align", "stem", "bottleneck")
# loads the program in a new process (only the ops registered, as a user
# would) and runs it on the saved image: outputs and launch counts to files
FRESH_PROCESS = """
import json, sys, time
import numpy as np, torch
import maskrcnn_tpu_torch.ops
from maskrcnn_tpu_torch.ops import cuda_lib
d = sys.argv[1]
t0 = time.perf_counter()
program = torch.export.load(d + "/model.pt2").module()
load_s = time.perf_counter() - t0
images = torch.from_numpy(np.load(d + "/images.npy")).to(sys.argv[2])
cuda_lib.reset_launches()
with torch.no_grad():
    out = program(images)
if images.is_cuda:
    torch.cuda.synchronize()
np.savez(d + "/fresh.npz", **{k: v.float().cpu().numpy()
                              for k, v in out.items()})
print(json.dumps({"load_s": load_s, "launches": dict(cuda_lib.launches),
                  "jax_loaded": sorted(m for m in sys.modules
                                       if m.split(".")[0] in
                                       ("jax", "maskrcnn_tpu"))}))
"""


def export_phase(dev, seed, base):
    """`io/export.py` at R101-FPN @ 1024^2, 81 classes, bf16, batch 1 on
    the card: the trace, the saved program's size, then the program
    reloaded in this process (counts zeroed just before its forward, read
    just after: it must launch K1-K4) and in a new one, each against the
    eager forward on one image (max |diff| <= EXPORT_TOL, `valid` equal),
    and the reloaded program's forward time beside the eager one's."""
    import os
    import tempfile
    from maskrcnn_tpu_torch.io import export
    from maskrcnn_tpu_torch.models import mask_rcnn as M
    from maskrcnn_tpu_torch.ops import cuda_lib
    cfg = base
    gen = torch.Generator().manual_seed(seed)
    params = M.init_mask_rcnn(gen, cfg)
    live_bn(params, gen)
    params = M.params_to(params, dev)
    size = cfg.image_height
    images = np.random.default_rng(seed).uniform(
        0, 255, (1, size, size, 3)).astype(np.float32)
    x = torch.from_numpy(images).to(dev)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        export.export_program(params, cfg, d, batch=1, device=dev)
        trace_s = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(d, export.PROGRAM))
        np.save(os.path.join(d, "images.npy"), images)
        # the new process loads the program while this one does the same
        t_fresh = time.perf_counter()
        fresh_proc = subprocess.Popen(
            [sys.executable, "-c", FRESH_PROCESS, d, str(dev)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        try:
            t0 = time.perf_counter()
            program = export.load_program(d)
            load_s = time.perf_counter() - t0
            with torch.no_grad():
                program(x)                                    # warm-up
            torch.cuda.synchronize()
            cuda_lib.reset_launches()
            with torch.no_grad():
                got = program(x)                              # main path
            torch.cuda.synchronize()
            launches = dict(cuda_lib.launches)
            want = M.forward(params, x, cfg, device=dev)
            # timed once the new process is done: no neighbour on the host
            stdout, stderr = fresh_proc.communicate(timeout=600)
            fresh_s = time.perf_counter() - t_fresh

            def ms(fn):
                out = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    with torch.no_grad():
                        fn(x)
                    torch.cuda.synchronize()
                    out.append((time.perf_counter() - t0) * 1e3)
                return out

            program_ms = ms(program)
            eager_ms = ms(lambda im: M.forward(params, im, cfg, device=dev))
        finally:
            if fresh_proc.poll() is None:
                fresh_proc.kill()
                fresh_proc.wait()
        if fresh_proc.returncode != 0:
            raise AssertionError(f"export: the program did not run in a new "
                                 f"process:\n{stderr[-3000:]}")
        fresh = json.loads(stdout.strip().splitlines()[-1])
        with np.load(os.path.join(d, "fresh.npz")) as z:
            fresh_out = {k: z[k] for k in z.files}

    def diff(a, b):
        return {k: float(np.abs(np.asarray(a[k], np.float32)
                                - b[k].float().cpu().numpy()).max())
                for k in ("detections", "masks", "valid")}

    err = diff({k: v.float().cpu().numpy() for k, v in got.items()}, want)
    err_fresh = diff(fresh_out, want)
    row = {"phase": "export", "config": describe(cfg) + ", batch 1",
           "trace_s": trace_s, "program_bytes": size, "load_s": load_s,
           "program_forward_ms": program_ms, "eager_forward_ms": eager_ms,
           "max_abs_diff": err, "fresh_process": {
               "seconds": fresh_s, "load_s": fresh["load_s"],
               "max_abs_diff": err_fresh, "launches": fresh["launches"],
               "jax_loaded": fresh["jax_loaded"]},
           "detections": int(want["valid"].sum()), "tol": EXPORT_TOL,
           "launches": launches}
    emit(row)
    problems = []
    for where, e, n in (("reloaded", err, launches),
                        ("new process", err_fresh, fresh["launches"])):
        if max(e.values()) > EXPORT_TOL:
            problems.append(f"{where}: max |diff| {e}")
        missing = [k for k in EXPORT_KERNELS if n[k] == 0]
        if missing:
            problems.append(f"{where}: never launched {missing}")
    if fresh["jax_loaded"]:
        problems.append(f"new process loaded {fresh['jax_loaded']}")
    if problems:
        raise AssertionError(f"export: {problems}")
    return {"export": launches}


BN_LAYERS = ("bn_conv1", "bn3a_branch2a", "bn5c_branch2c")
DP_LOSS_RTOL, DP_PARAM_ATOL = 5e-2, 1e-4   # `parallel/mesh.py::dryrun_step`


def _train_setup(cfg, seed, dev, batch):
    from maskrcnn_tpu_torch.core.anchors import generate_anchors
    from maskrcnn_tpu_torch.models import mask_rcnn as M
    from maskrcnn_tpu_torch.train import step as T
    from maskrcnn_tpu_torch.train.data import synthetic_train_batch
    gen = torch.Generator().manual_seed(seed)
    params = M.init_mask_rcnn(gen, cfg)
    live_bn(params, gen)
    state, opt = T.make_train_state(M.params_to(params, dev), cfg)
    data = synthetic_train_batch(cfg, batch, dev, seed=seed + 1)
    anchors = torch.from_numpy(generate_anchors(cfg)).to(dev)
    return state, opt, data, anchors


def _state_delta(a, b) -> float:
    return max(float((a[k][w] - b[k][w]).abs().max())
               for k in a for w in a[k])


def _allclose_ratio(a, b, rtol, atol) -> float:
    """max over the leaves of |a - b| / (atol + rtol |b|): at most 1 where
    `np.testing.assert_allclose(a, b, rtol, atol)` passes."""
    return max(float(((a[k][w] - b[k][w]).abs()
                      / (atol + rtol * b[k][w].abs())).max())
               for k in a for w in a[k])


def _dp_gloo_rank(rank, world, store, seed, out, device, base):
    """One rank of the gloo world on the one card: a frozen-BN DP step on
    this rank's image (rank 0 then runs the single-process step on both),
    then the batch-BN statistics over the world's group at BN_LAYERS
    against one process's over the gathered inputs, and one batch-BN DP
    step."""
    import torch.distributed as dist
    from maskrcnn_tpu_torch.models import mask_rcnn as M
    from maskrcnn_tpu_torch.models import nn
    from maskrcnn_tpu_torch.parallel import mesh
    from maskrcnn_tpu_torch.train import step as T
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        res, state = {}, None
        for mode in ("frozen", "batch"):
            cfg = base.replace(train_bn=mode)
            if state is None:
                state, opt, data, anchors = _train_setup(cfg, seed, dev,
                                                         world)
                mesh.broadcast_state(state)
            else:
                state, opt = T.make_train_state(state.params, cfg)
            shard = {k: v[rank:rank + 1] for k, v in data.items()}
            step = mesh.data_parallel_train_step(cfg, opt)
            step_ms = []
            for _ in range(2):          # from the same state: the first warms
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                new, m = step(state, shard, anchors, seed=seed)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
            loss = float(m["loss"])
            if rank == 0:
                single, sm = T.train_step(state, data, anchors, cfg, opt,
                                          seed=seed)
                res[mode] = {"loss": loss, "single_loss": float(sm["loss"]),
                             "param_delta": _state_delta(new.params,
                                                         single.params),
                             "step_ms": step_ms}
                del single
            if mode == "batch":
                seen, stats = {}, {}
                orig = nn.batch_norm

                def spy(x, p, **kw):
                    if kw.get("name") in BN_LAYERS:
                        seen[kw["name"]] = x.detach().float()
                    return orig(x, p, **kw)

                nn.batch_norm = spy
                try:
                    with torch.no_grad():
                        M.backbone_fpn(
                            state.params, M.preprocess(shard["images"], cfg),
                            cfg, torch.bfloat16, inference=False,
                            bn_ctx={"use_batch_stats": True,
                                    "collect": stats,
                                    "group": dist.group.WORLD})
                finally:
                    nn.batch_norm = orig
                rel = {}
                for name in BN_LAYERS:
                    parts = [torch.empty_like(seen[name])
                             for _ in range(world)]
                    dist.all_gather(parts, seen[name])
                    xs = torch.cat(parts).reshape(-1, parts[0].shape[-1])
                    want = (xs.mean(0), xs.var(0, unbiased=False))
                    rel[name] = max(float(((g - w).abs() / w.abs().clamp_min(
                        1e-6)).max()) for g, w in zip(stats[name], want))
                if rank == 0:
                    res["bn_stats_rel_err"] = rel
            del new
            torch.cuda.empty_cache()
        if rank == 0:
            with open(out, "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


def dp(dev, seed, batch, base):
    """Data parallel on the one card: (a) `MaskRCNNDetector(data_parallel=
    -1)` against the single-device detector, bit for bit, on 4 float32
    canvases and an odd uint8 batch of 3 (the padding path; the
    DP run is a main path, counted); (b) the DP train step over NCCL,
    world 1, against `train_step` (float32, frozen BN, exact sampling:
    `tests/test_parallel.py`'s n = 1 bounds); (c) gloo, world 2 on the one
    card, one image a rank (`_dp_gloo_rank`), started first so that it
    runs beside (a) and (b)."""
    import os
    import tempfile
    import torch.multiprocessing as mp
    gloo_dir = tempfile.TemporaryDirectory()
    gloo_out = os.path.join(gloo_dir.name, "rank0.json")
    t_gloo = time.perf_counter()
    ranks = mp.spawn(_dp_gloo_rank, args=(
        2, os.path.join(gloo_dir.name, "store"), seed, gloo_out, str(dev),
        base), nprocs=2, join=False)
    try:
        launches, equal, nccl, launches_nccl = _dp_one_process(
            dev, seed, batch, base)
        while not ranks.join():
            pass
    finally:
        for proc in ranks.processes:
            if proc.is_alive():
                proc.terminate()
                proc.join()
    gloo_s = time.perf_counter() - t_gloo
    with open(gloo_out) as f:
        gloo = json.load(f)
    gloo_dir.cleanup()
    # `dryrun_step` as a user calls it: rank 0 on card 0 over NCCL (it
    # raises where a rank's step or the DP forward fails its bounds)
    from maskrcnn_tpu_torch.parallel import mesh
    t_dry = time.perf_counter()
    mesh.dryrun_step(1)
    dryrun_s = time.perf_counter() - t_dry
    emit({"phase": "dp", "devices": torch.cuda.device_count(),
          "detector_equal": {"float32_batch_4": equal[0], "uint8_batch_3":
                             equal[1]}, "launches": launches,
          "nccl_world_1": nccl, "nccl_launches": launches_nccl,
          "gloo_world_2": gloo, "gloo_seconds": gloo_s,
          "dryrun_step_nccl_1_seconds": dryrun_s,
          "bounds": {"nccl": "each *_ratio <= 1: losses rtol 1e-6 atol "
                     "1e-6, params and momentum rtol 1e-5 atol 1e-6 "
                     "(tests/test_parallel.py, n = 1)",
                     "gloo": f"loss rtol {DP_LOSS_RTOL}; frozen BN params "
                     f"atol {DP_PARAM_ATOL}; batch BN statistics 1e-5 "
                     "relative (its params are recorded: batch statistics "
                     "carry bf16 rounding flips through every layer)"}})
    problems = []
    if not all(equal):
        problems.append(f"DP detector differs from one device: {equal}")
    if max(nccl["loss_ratio"], nccl["param_ratio"],
           nccl["momentum_ratio"]) > 1:
        problems.append(f"NCCL world 1: {nccl}")
    for mode in ("frozen", "batch"):
        g = gloo[mode]
        if not (abs(g["loss"] - g["single_loss"])
                < DP_LOSS_RTOL * max(1.0, abs(g["single_loss"]))
                and (mode == "batch" or g["param_delta"] < DP_PARAM_ATOL)):
            problems.append(f"gloo world 2, {mode} BN: {g}")
    if max(gloo["bn_stats_rel_err"].values()) > 1e-5:
        problems.append(f"BN statistics: {gloo['bn_stats_rel_err']}")
    missing = [k for k in EXPORT_KERNELS if launches[k] == 0]
    if missing:
        problems.append(f"DP detector never launched {missing}")
    if problems:
        raise AssertionError(f"dp: {problems}")
    return {"dp": launches, "dp_train_nccl": launches_nccl}


def _dp_one_process(dev, seed, batch, base):
    """(a) and (b) of `dp`: (launches of the DP detector's run, [float32
    equal, uint8 equal], the NCCL comparison, the DP step's launches)."""
    import os
    import tempfile
    import torch.distributed as dist
    from maskrcnn_tpu_torch.models import mask_rcnn as M
    from maskrcnn_tpu_torch.ops import cuda_lib
    from maskrcnn_tpu_torch.parallel import mesh
    from maskrcnn_tpu_torch.pipeline.detector import MaskRCNNDetector
    from maskrcnn_tpu_torch.train import step as T
    cfg = base.replace(detection_score_threshold=0.0)
    gen = torch.Generator().manual_seed(seed)
    params = M.init_mask_rcnn(gen, cfg)
    live_bn(params, gen)
    one = MaskRCNNDetector(cfg, params, device=dev)
    many = MaskRCNNDetector(cfg, one.params, device=dev, data_parallel=-1)
    rng = np.random.default_rng(seed)
    hw = (cfg.image_height, cfg.image_width, 3)
    batches = [rng.uniform(0, 255, (4, *hw)).astype(np.float32),
               rng.integers(0, 256, (3, *hw), dtype=np.uint8)]
    many.run_batch(batches[0])                                # warm-up
    torch.cuda.synchronize()
    equal, launches = [], None
    for images in batches:
        want = one.run_batch(images)
        cuda_lib.reset_launches()
        got = many.run_batch(images)                          # main path
        torch.cuda.synchronize()
        launches = launches or dict(cuda_lib.launches)
        equal.append(sorted(got) == sorted(want) and all(
            torch.equal(got[k], want[k]) for k in want))
    del one, many
    torch.cuda.empty_cache()

    # atomics in some backward kernels add in another order each run:
    # the deterministic algorithms where PyTorch has one
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    tcfg = base.replace(compute_dtype="float32", train_bn="frozen",
                        train_sampling_topk="exact")
    state, opt, data, anchors = _train_setup(tcfg, seed, dev, batch)
    single, sm = T.train_step(state, data, anchors, tcfg, opt, seed=seed)
    with tempfile.TemporaryDirectory() as d:
        store = dist.FileStore(os.path.join(d, "store"), 1)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=store, rank=0, world_size=1)
        try:
            cuda_lib.reset_launches()
            new, m = mesh.data_parallel_train_step(tcfg, opt)(
                state, data, anchors, seed=seed)              # main path
            torch.cuda.synchronize()
            launches_nccl = dict(cuda_lib.launches)
        finally:
            dist.destroy_process_group()
    torch.backends.cudnn.deterministic = False
    torch.use_deterministic_algorithms(False)
    # `tests/test_parallel.py`, n = 1: losses rtol 1e-6, params and
    # momentum rtol 1e-5 + atol 1e-6
    nccl = {"loss_ratio": max(abs(float(m[k]) - float(sm[k]))
                              / (1e-6 + 1e-6 * abs(float(sm[k])))
                              for k in sm),
            "param_ratio": _allclose_ratio(new.params, single.params, 1e-5,
                                           1e-6),
            "momentum_ratio": _allclose_ratio(new.momentum, single.momentum,
                                              1e-5, 1e-6),
            "param_delta": _state_delta(new.params, single.params),
            "momentum_delta": _state_delta(new.momentum, single.momentum)}
    del state, opt, data, single, new
    torch.cuda.empty_cache()
    return launches, equal, nccl, launches_nccl


def bench(batch):
    """`maskrcnn_tpu_torch.tools.bench` with the unfused and the fused
    heads, then `--mode train` in both training configurations; its JSON
    lines are printed as they are."""
    import contextlib
    import io
    from maskrcnn_tpu_torch.ops import cuda_lib
    from maskrcnn_tpu_torch.tools import bench as bench_tool
    launches = {}
    for key, flags, want in (
            ("none", ["--fuse", "none"],
             ("roi_align", "stem", "nms", "bottleneck")),
            ("both", ["--fuse", "both"],
             ("roi_classifier_head", "roi_mask_head", "stem", "nms",
              "bottleneck")),
            ("mobilenetv2", ["--fuse", "none", "--arch", "mobilenetv2"],
             ("roi_align", "nms"))):
        buf = io.StringIO()
        cuda_lib.reset_launches()
        with contextlib.redirect_stdout(buf):
            rc = bench_tool.main(["--batch", str(batch), "--iters", "10",
                                  "--warmup", "3"] + flags)
        launches[f"bench_{key}"] = dict(cuda_lib.launches)
        if rc != 0:
            raise AssertionError(f"bench {flags} exited {rc}")
        line = buf.getvalue().strip().splitlines()[-1]
        print(line, flush=True)
        result = json.loads(line)
        emit({"phase": f"bench_{key}", "launches": launches[f"bench_{key}"],
              "result": result})
        if not (result["value"] > 0 and np.isfinite(result["p99_ms"])):
            raise AssertionError(f"bench {flags}: {result}")
        missing = [k for k in want if launches[f"bench_{key}"][k] == 0]
        if missing:
            raise AssertionError(f"bench {flags} never launched {missing}")
        torch.cuda.empty_cache()
    for name, flags, want in (
            ("batch_bn", ["--train-bn", "batch"], ("nms", "roi_align")),
            ("frozen_bn_fused", ["--train-bn", "frozen",
                                 "--train-fused-kernels"],
             ("nms", "roi_align", "stem", "bottleneck"))):
        buf = io.StringIO()
        cuda_lib.reset_launches()
        with contextlib.redirect_stdout(buf):
            rc = bench_tool.main(["--mode", "train", "--batch", str(batch),
                                  "--iters", "2", "--warmup", "1"] + flags)
        key = f"bench_train_{name}"
        launches[key] = dict(cuda_lib.launches)
        if rc != 0:
            raise AssertionError(f"bench --mode train {flags} exited {rc}")
        line = buf.getvalue().strip().splitlines()[-1]
        print(line, flush=True)
        result = json.loads(line)
        emit({"phase": key, "launches": launches[key], "result": result})
        if not (result["train_images_per_s"] > 0
                and np.isfinite(result["step_p95_ms"])):
            raise AssertionError(f"bench --mode train {flags}: {result}")
        missing = [k for k in want if launches[key][k] == 0]
        if missing:
            raise AssertionError(f"bench --mode train {flags} never "
                                 f"launched {missing}")
        torch.cuda.empty_cache()
    return launches


def serve_probe_checks(dev, rng, batch, params) -> dict:
    """K1-K4 held against their plain versions at `batch`, the shapes the
    serve_probe path gives them; each fails the run as at `--batch`.
    -> {row name: its numbers at `batch`}."""
    pyramid = [torch.from_numpy(rng.standard_normal(
        (batch, s, s, 256)).astype(np.float32)).to(dev)
        .to(torch.bfloat16) for s in (256, 128, 64, 32)]
    rows = check_nms(dev, rng, batch) + check_roi_align(dev, rng, batch,
                                                       pyramid)
    del pyramid
    rows += check_stem(dev, rng, batch, params)
    rows += check_chains(dev, rng, batch, params)
    torch.cuda.empty_cache()
    return {r["name"]: {"batch": batch, **{k: r[k] for k in (
        "max_abs_err", "tol", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "bias", "bias_by_block", "ok") if k in r}}
        for r in rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--kernels-only", action="store_true",
                    help="the device, build and K1..K6 phases, then a "
                         "kernels line without launches and no result "
                         "line: two kernel builds compared in one call")
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
    rows += check_fused_heads(dev, rng, args.batch, pyramid, params)
    del pyramid
    rows += check_stem(dev, rng, args.batch, params)
    rows += check_chains(dev, rng, args.batch, params)
    # K1-K4 again at the serve_probe path's batch, held the same way
    at_probe = serve_probe_checks(dev, rng, SERVE_PROBE_MAX_BATCH, params)
    del params
    torch.cuda.empty_cache()
    failed = ([r["name"] for r in rows if not r["ok"]]
              + [f"{name} at batch {r['batch']}"
                 for name, r in at_probe.items() if not r["ok"]])
    if args.kernels_only:
        for row in rows:
            if row["name"] in at_probe:
                row["serve_probe_batch"] = at_probe[row["name"]]
        emit({"kernels": rows})
        print(smi, flush=True)
        return 1 if failed else 0
    if failed:
        raise AssertionError("kernel rows failed their checks (their lines "
                             "above have the readings): " + ", ".join(failed))

    native_phase(args.seed)
    check_small_forward(dev, args.seed)
    launches = e2e(dev, args.seed, args.batch)
    torch.cuda.empty_cache()
    launches_stream = stream(dev, args.seed, args.batch)
    torch.cuda.empty_cache()
    by_path = {"e2e": launches, "stream": launches_stream}
    full = MaskRCNNConfig()            # R101-FPN @ 1024^2, 81 classes, bf16
    by_path.update(mnv2(dev, args.seed, args.batch, full))
    torch.cuda.empty_cache()
    by_path.update(export_phase(dev, args.seed, full))
    torch.cuda.empty_cache()
    by_path.update(dp(dev, args.seed, args.batch, full))
    torch.cuda.empty_cache()
    train_paths, train_per_step, train_grads = train(dev, args.seed,
                                                     args.batch)
    by_path.update(train_paths)
    torch.cuda.empty_cache()
    by_path["serve"] = serve(dev, args.seed, args.batch, full)
    torch.cuda.empty_cache()
    by_path["serve_probe"] = serve_probe_phase(dev, args.seed, full)
    torch.cuda.empty_cache()
    evaluate_bench()
    by_path.update(cli(dev, args.seed, args.batch, full))
    torch.cuda.empty_cache()
    by_path.update(proof(dev, args.seed, args.batch, full))
    torch.cuda.empty_cache()
    by_path.update(bench(args.batch))

    family = {"K1": "nms", "K2": "roi_align", "K3": "stem", "K4": "bottleneck",
              "K5": "roi_classifier_head", "K6": "roi_mask_head"}
    for row in rows:
        key = family[row["name"][:2]]
        row["launches"] = (launches_stream if key in ("roi_classifier_head",
                                                      "roi_mask_head")
                           else launches)[key]
        row["launches_by_path"] = {p: n[key] for p, n in by_path.items()}
        row["train_launches_per_step"] = {c: n[key]
                                          for c, n in train_per_step.items()}
        if row["name"] in at_probe:
            row["serve_probe_batch"] = at_probe[row["name"]]
        grad = train_grads.get(row["name"])   # K2, K3, K4 at train shapes
        if grad:
            row["train_fwd_ms"] = grad["fwd_ms"]
            row["train_bwd_ms"] = grad["bwd_ms"]
            row["train_fwd_max_abs_err"] = grad["fwd_max_abs_err"]
            row["train_max_rel_grad_err"] = grad["max_rel_grad_err"]
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
