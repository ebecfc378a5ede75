"""Ablation probes of K1 (NMS), K2 (ROIAlign), K3 (stem), K4 (bottleneck
chain), K5 (classifier head) and K6 (mask head) on one NVIDIA card, at the
main paths' shapes (R101-FPN @ 1024^2, batch 2):

    python3 -m maskrcnn_tpu_torch.tools.probe_kernels [K1 K2 K3 K4 K5 K6 ...]

(names: the calls to time, by prefix; all by default)

Each probe rebuilds the kernels from a copy of `csrc/` with one piece of
work taken out or changed (the results of a piece taken out are wrong;
only the time is read) and times the kernel against the unmodified build
in the same process. What a kernel loses when a piece goes is what that
piece costs it; `equal_to_unmodified` says whether the output stayed the
same. Also prints each call's device time per kernel (torch.profiler), for
K2 and K3 with L2 cold as well (`ms_l2_cold`), for K5 and K6 the share of
their pool pass (K2's kernel). Prints JSON lines, the card's nvidia-smi
name and power limit last; needs a card.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

from maskrcnn_tpu_torch.ops import cuda_lib

_STAGE2 = "  // ---- stage 2: t2 = relu(conv3x3(t1) + b2)"
_STAGE3 = "  // ---- stage 3: out = relu((t2 @ w3 + b3) + shortcut)"
_EXIT = "  cp_async_wait<0>();\n  if (y0 >= 0) return;\n"
_K3_CONV = "    // ---- conv: implicit GEMM"
_K3_POOL = "    // ---- pool 3x3/2"

# name -> (source, text, replacement)
ABLATIONS = {
    "k4_no_output_stores": (
        "bottleneck.cu", "      *reinterpret_cast<uint4*>(g.out + pix",
        "      if (pix == ~(size_t)0) *reinterpret_cast<uint4*>(g.out + pix"),
    "k4_no_mma": ("bottleneck.cu", "mma16816_rn(", "(void)("),
    "k4_no_barrier": ("bottleneck.cu",
                      "    cp_async_wait<S - 2>();\n    __syncthreads();",
                      "    cp_async_wait<S - 2>();"),
    "k4_no_weight_refill": (
        "bottleneck.cu",
        "if (j + S - 1 < total) load_chunk(j + S - 1);",
        "if (j + S - 1 < S - 1) load_chunk(j + S - 1);"),
    # Early exits: the time through stage 1, and through stage 2. The
    # compiler may drop work whose results the exit leaves unread.
    "k4_stage_1_only": ("bottleneck.cu", _STAGE2, _EXIT + _STAGE2),
    "k4_stages_1_2_only": ("bottleneck.cu", _STAGE3, _EXIT + _STAGE3),
    # K3: the time without the pool; the input staging alone (fetch, bf16
    # rounding); everything but the tensor-core products; the 8 x 7 tile.
    "k3_no_pool": ("stem.cu", _K3_POOL, "    continue;\n" + _K3_POOL),
    "k3_staging_only": ("stem.cu", _K3_CONV, "    continue;\n" + _K3_CONV),
    "k3_no_mma": ("stem.cu", "wgmma_64(part, a,", "(void)(part, a,"),
    "k3_tile_8x7": ("stem.cu", "constexpr int kTileH = 12, kTileW = 7;",
                    "constexpr int kTileH = 8, kTileW = 7;"),
    # K2: four items in flight a thread instead of two.
    "k2_unroll_4": ("roi_align.cu", "constexpr int kUnroll = 2;",
                    "constexpr int kUnroll = 4;"),
}


def _build(name: str | None):
    """Point cuda_lib at csrc (name None) or at a copy with one ablation."""
    base = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    csrc, build = os.path.join(base, "csrc"), os.path.join(base, "build")
    if name is not None:
        src, old, new = ABLATIONS[name]
        build = os.path.join(build, "probe_" + name)
        shutil.rmtree(build, ignore_errors=True)
        shutil.copytree(csrc, os.path.join(build, "csrc"))
        path = os.path.join(build, "csrc", src)
        with open(path) as f:
            text = f.read()
        if old not in text:
            raise RuntimeError(f"{name}: {src} no longer has the text it "
                               "takes out")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
        csrc = os.path.join(build, "csrc")
    cuda_lib.CSRC, cuda_lib.BUILD, cuda_lib._lib = csrc, build, None
    cuda_lib.load()


def _same(fn, want: torch.Tensor) -> bool:
    """fn()'s output equals `want`: its output memory is first filled with
    all-ones bytes (the allocator hands the freed block back), so a probe
    that skips a write does not read the last call's values."""
    junk = torch.empty_like(want)
    junk.view(torch.uint8).fill_(255)
    del junk
    return torch.equal(fn(), want)


def _by_kernel(fn, reps: int = 5) -> dict:
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0) or 0
        if us:
            key = re.sub(r"\(anonymous namespace\)::|\(.*", "", ev.key)
            out[key] = us / reps / 1e3
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from maskrcnn_tpu_torch.core.config import MaskRCNNConfig
    from maskrcnn_tpu_torch.models import mask_rcnn as M
    from maskrcnn_tpu_torch.ops import bottleneck_cuda as bc
    from maskrcnn_tpu_torch.ops import nms_cuda
    from maskrcnn_tpu_torch.ops import roi_align as ra
    from maskrcnn_tpu_torch.ops import roi_align_cuda as rac
    from maskrcnn_tpu_torch.ops import stem_cuda

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    params = M.init_mask_rcnn(gen, MaskRCNNConfig())
    cs.live_bn(params, gen, gamma=(0.5, 1.5))
    params = M.params_to(params, dev)
    pyramid = [torch.from_numpy(rng.standard_normal((2, s, s, 256))
                                .astype(np.float32)).to(dev)
               .to(torch.bfloat16) for s in (256, 128, 64, 32)]
    hw = [(f.shape[1], f.shape[2]) for f in pyramid]
    rois = cs.spread_rois(rng, 2, 1000).to(dev)
    prep = ra.prepare(rois.reshape(-1, 4), hw, (1024, 1024), 224.0, 7)
    head = rac.pack_classifier_head(params, 81, torch.bfloat16)
    calls = {"K5": lambda: rac.roi_classifier_head(pyramid, *prep, 1000,
                                                   head)}
    rois = cs.spread_rois(rng, 2, 100).to(dev)
    prep14 = ra.prepare(rois.reshape(-1, 4), hw, (1024, 1024), 224.0, 14)
    mask = rac.pack_mask_head(params, torch.bfloat16)
    ids = torch.from_numpy(rng.integers(1, 81, 200).astype(np.int32)).to(dev)
    calls["K6"] = lambda: rac.roi_mask_head(pyramid, *prep14, 100, mask, ids)
    calls["K2_pool7"] = lambda: rac.roi_align(pyramid, *prep, 1000)
    calls["K2_pool14"] = lambda: rac.roi_align(pyramid, *prep14, 100)
    w, bias = stem_cuda.fold_stem_weights(params["conv1"], params["bn_conv1"])
    images = torch.from_numpy(rng.uniform(-124, 132, (2, 1024, 1024, 3))
                              .astype(np.float32)).to(dev)
    calls["K3"] = lambda: stem_cuda.stem(images, w, bias)
    for stage, n, t, max_out, classes in (("proposals", 6000, 0.7, 1000, 0),
                                          ("detections", 1000, 0.3, 100, 8)):
        boxes = cs.clustered_boxes(rng, 2, n, classes).to(dev)
        cand = torch.ones((2, n), dtype=torch.bool, device=dev)
        calls[f"K1_{stage}"] = (
            lambda boxes=boxes, cand=cand, t=t, max_out=max_out:
            nms_cuda.nms_keep(boxes, cand, t, max_out))
    for stage, letters, side, cin in ((2, "abc", 256, 64),
                                      (3, "bcd", 128, 512)):
        blocks = bc.fold_bottleneck_chain(params, stage, letters)
        x = torch.from_numpy(rng.standard_normal((2, side, side, cin))
                             .astype(np.float32)).to(dev).to(torch.bfloat16)
        calls[f"K4_res{stage}{letters}"] = (
            lambda x=x, blocks=blocks: bc.fused_bottleneck_chain(x, blocks))

    only = tuple(sys.argv[1:])
    calls = {k: v for k, v in calls.items() if not only or k.startswith(only)}
    _build(None)
    base, outs, graph = {}, {}, {}
    for name, fn in calls.items():
        base[name] = cs.cuda_ms(fn, 20)
        outs[name] = fn().clone()
        row = {"probe": "none", "call": name, "ms": base[name],
               "ms_by_kernel": _by_kernel(fn)}
        if name[:2] in ("K2", "K3"):
            row["ms_l2_cold"] = cs.cuda_ms_l2_cold(fn, 10)
            row["ms_graph"] = graph[name] = cs.cuda_ms_graph(fn)
        if name in ("K5", "K6"):
            pool = sum(v for k, v in row["ms_by_kernel"].items()
                       if "roi_align_kernel" in k)
            row["pool_pass_ms"] = pool
            row["pool_pass_share"] = pool / sum(row["ms_by_kernel"].values())
        print(json.dumps(row), flush=True)
    for probe in ABLATIONS:
        if not any(name[:2] == probe[:2].upper() for name in calls):
            continue
        _build(probe)
        for name, fn in calls.items():
            if name[:2] == probe[:2].upper():
                row = {"probe": probe, "call": name,
                       "ms": cs.cuda_ms(fn, 20), "ms_unmodified": base[name]}
                if name in graph:
                    row["ms_graph"] = cs.cuda_ms_graph(fn)
                    row["ms_graph_unmodified"] = graph[name]
                row["equal_to_unmodified"] = _same(fn, outs[name])
                print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
