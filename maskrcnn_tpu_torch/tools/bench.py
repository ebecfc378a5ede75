"""Benchmark of the port on one NVIDIA card, printed last as one JSON line
in the shape of the JAX package's `bench.py`.

`--mode infer` (default): images/s of the detector forward end to end
(`MaskRCNNDetector.run_batch`: preprocess on the card through detections
and masks). `--mode train`: images/s of `train_step` (forward, the five
losses, backward, the SGD update) on a fixed synthetic batch.

    python -m maskrcnn_tpu_torch.tools.bench                 # R101 @ 1024^2
    python -m maskrcnn_tpu_torch.tools.bench --fuse both     # K5/K6 heads
    python -m maskrcnn_tpu_torch.tools.bench --arch mobilenetv2
    python -m maskrcnn_tpu_torch.tools.bench --mode train --train-bn frozen \\
        --train-fused-kernels                             # K3/K4 in training
    python -m maskrcnn_tpu_torch.tools.bench --preset tiny --batch 2

Inference: the input batch is staged on the card once, as uint8, so the
host-to-device copy is not timed. Latency: `--iters` blocking calls, each
`run_batch` plus a one-element readback (p50 / p95 / p99). Throughput:
`--iters` calls dispatched back to back with one readback at the end.
Training: the batch (8 GT boxes an image, 28^2 mini-masks, from seed 1)
is staged on the card once; `--iters` steps, each ended by a readback of
the loss (blocking), give the step time p50 / p95 and images/s (batch /
p50), and `max_memory_allocated` covers the timed steps. Weights and
pixels are random from seed 0. Without a card it prints no result and
exits non-zero: it measures the card only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="maskrcnn_tpu_torch.tools.bench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=("full", "tiny"), default="full")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--arch", default="resnet101",
                    choices=("resnet101", "resnet50", "mobilenetv2"),
                    help="backbone for the full preset")
    ap.add_argument("--fuse", choices=("config", "none", "cls", "mask",
                                       "both"), default="config",
                    help="override the fused-head flags: the classifier "
                         "head (K5) and/or the mask head (K6)")
    ap.add_argument("--mode", choices=("infer", "train"), default="infer")
    ap.add_argument("--train-bn", choices=("batch", "frozen"),
                    help="train mode: override config.train_bn")
    ap.add_argument("--train-fused-kernels", action="store_true",
                    help="train mode: K3/K4 in the training forward "
                         "(config.train_fused_kernels; frozen BN only)")
    ap.add_argument("--remat", action="store_true",
                    help="train mode: recompute the backbone in the "
                         "backward (config.train_remat_backbone)")
    ap.add_argument("--bf16-momentum", action="store_true",
                    help="train mode: bfloat16 momentum trace "
                         "(config.train_momentum_dtype)")
    return ap


def nvidia_smi_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bench: no CUDA device; this benchmark measures the card "
              "only", file=sys.stderr)
        return 2
    import numpy as np

    from maskrcnn_tpu_torch.core.config import (MaskRCNNConfig,
                                                tiny_test_config)
    from maskrcnn_tpu_torch.models.mask_rcnn import init_mask_rcnn
    from maskrcnn_tpu_torch.pipeline.detector import MaskRCNNDetector

    if args.preset == "tiny":
        config = tiny_test_config()
    else:
        config = MaskRCNNConfig(architecture=args.arch)
    if args.fuse != "config":
        config = config.replace(
            fuse_classifier_head=args.fuse in ("cls", "both"),
            fuse_mask_head=args.fuse in ("mask", "both"))
    batch = args.batch
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    if args.mode == "train":
        return bench_train(args, config, dev, smi)
    detector = MaskRCNNDetector(
        config, init_mask_rcnn(torch.Generator().manual_seed(0), config),
        device=dev)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(
        0, 256, (batch, config.image_height, config.image_width, 3),
        dtype=np.uint8)).to(dev)
    print(f"# bench: {config.architecture} @ {config.image_height}x"
          f"{config.image_width}, batch={batch}, fuse={args.fuse}, "
          f"{config.compute_dtype}; input staged on the device once as "
          f"uint8 {tuple(images.shape)}; device={smi}", file=sys.stderr)

    def run():
        out = detector.run_batch(images)
        out["detections"][0, 0, 0].item()    # readback: waits for the card

    t0 = time.perf_counter()
    run()
    print(f"# first call: {time.perf_counter() - t0:.2f}s", file=sys.stderr)
    for _ in range(args.warmup):
        run()

    times = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    p50, p95, p99 = (float(np.percentile(np.asarray(times) * 1e3, q))
                     for q in (50, 95, 99))

    t0 = time.perf_counter()
    out = None
    for _ in range(args.iters):
        out = detector.run_batch(images)
    out["detections"][0, 0, 0].item()
    pipelined = (time.perf_counter() - t0) / args.iters
    img_per_s = batch / pipelined
    print(f"# blocking p50 {p50:.2f} ms (p95 {p95:.2f} / p99 {p99:.2f}); "
          f"pipelined {pipelined * 1e3:.2f} ms per batch -> "
          f"{img_per_s:.2f} img/s", file=sys.stderr)
    print(json.dumps({
        "metric": f"images_per_sec_{config.architecture}_"
                  f"{config.image_height}",
        "value": img_per_s,
        "unit": "images/sec",
        "p50_ms": p50, "p95_ms": p95, "p99_ms": p99,
        "batch": batch,
        "fuse": args.fuse,
        "device": smi,
    }), flush=True)
    return 0


def bench_train(args, config, dev, smi) -> int:
    """`--mode train`: blocking `train_step`s on a fixed synthetic batch."""
    import numpy as np
    import torch

    from maskrcnn_tpu_torch.core.anchors import generate_anchors
    from maskrcnn_tpu_torch.models.mask_rcnn import init_mask_rcnn, params_to
    from maskrcnn_tpu_torch.train.data import synthetic_train_batch
    from maskrcnn_tpu_torch.train.step import make_train_state, train_step

    if args.train_bn:
        config = config.replace(train_bn=args.train_bn)
    config = config.replace(
        train_fused_kernels=args.train_fused_kernels,
        train_remat_backbone=args.remat,
        train_momentum_dtype="bfloat16" if args.bf16_momentum
        else "float32")
    if config.train_fused_kernels and config.train_bn != "frozen":
        print("# WARNING: --train-fused-kernels has no effect without "
              "--train-bn frozen (batch statistics cannot fold into the "
              "conv weights)", file=sys.stderr)
    b = args.batch
    params = params_to(init_mask_rcnn(torch.Generator().manual_seed(0),
                                      config), dev)
    batch_data = synthetic_train_batch(config, b, dev, seed=1)
    anchors = torch.from_numpy(generate_anchors(config)).to(dev)
    state, opt = make_train_state(params, config)
    del params
    print(f"# bench train: {config.architecture} @ {config.image_height}x"
          f"{config.image_width}, batch={b}, train_bn={config.train_bn}, "
          f"fused_kernels={config.train_fused_kernels}, "
          f"remat={config.train_remat_backbone}, "
          f"momentum={config.train_momentum_dtype}, {config.compute_dtype};"
          f" device={smi}", file=sys.stderr)

    def run(st):
        st, metrics = train_step(st, batch_data, anchors, config, opt,
                                 seed=2)
        loss = float(metrics["loss"])        # readback: waits for the card
        return st, loss

    t0 = time.perf_counter()
    state, loss = run(state)
    print(f"# first step: {time.perf_counter() - t0:.2f}s, loss {loss:.4f}",
          file=sys.stderr)
    for _ in range(args.warmup):
        state, loss = run(state)
    torch.cuda.reset_peak_memory_stats(dev)
    times, losses = [], []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        state, loss = run(state)
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    p50, p95 = (float(np.percentile(np.asarray(times) * 1e3, q))
                for q in (50, 95))
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"# train step p50 {p50:.1f} ms (p95 {p95:.1f}), "
          f"{b / p50 * 1e3:.2f} img/s, peak memory {peak / 2**30:.2f} GiB",
          file=sys.stderr)
    if not all(np.isfinite(losses)):
        print(f"bench: non-finite training loss {losses}", file=sys.stderr)
        return 1
    suffix = ("" if config.train_bn == "batch" else f"_{config.train_bn}bn") \
        + ("_remat" if config.train_remat_backbone else "") \
        + ("_fusedkernels" if config.train_fused_kernels else "") \
        + ("_bf16mom" if config.train_momentum_dtype == "bfloat16" else "")
    print(json.dumps({
        "metric": f"train_images_per_sec_{config.architecture}_"
                  f"{config.image_height}{suffix}",
        "value": b / p50 * 1e3,
        "unit": "images/sec",
        "train_images_per_s": b / p50 * 1e3,
        "step_p50_ms": p50, "step_p95_ms": p95,
        "max_memory_allocated": peak,
        "losses": losses,
        "batch": b,
        "train_bn": config.train_bn,
        "train_fused_kernels": config.train_fused_kernels,
        "remat": config.train_remat_backbone,
        "momentum_dtype": config.train_momentum_dtype,
        "device": smi,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
