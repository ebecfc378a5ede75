"""`maskrcnn_tpu_torch` command-line interface, port of
`maskrcnn_tpu/cli/main.py`: the same subcommands and flags, on the card.

    python -m maskrcnn_tpu_torch.cli convert  <name> [--config ... --weights ...]
    python -m maskrcnn_tpu_torch.cli evaluate <model> <dataset> [--limit 5 ...]
    python -m maskrcnn_tpu_torch.cli stream   <model> [--frames-dir DIR ...]
    python -m maskrcnn_tpu_torch.cli serve    <model> [--port 8389 --max-batch 8]
    python -m maskrcnn_tpu_torch.cli train    <model> [--synthetic ...]
    python -m maskrcnn_tpu_torch.cli demo     <model> <image> [-o out.png]
    python -m maskrcnn_tpu_torch.cli download <name> [--url URL]

Every subcommand that runs the model runs it on the card; `--device cpu`
asks for the plain PyTorch path on the CPU instead. `convert
--export-savedmodel DIR` writes a `torch.export` program (`io/export.py`)
where the JAX package writes a TF SavedModel; `evaluate --dp N` splits each
batch over N devices of `--device`'s kind. `evaluate --compare-tf` runs the
same weights through the TensorFlow oracle (`evalkit/tf_forward.py`) on the
host CPU and exits 2 where TensorFlow does not import (the card's machine).

Artifacts live under `$MASKRCNN_HOME/models/<name>/` (default
`.maskrcnn/`): inputs `config.json` + `weights.h5`, outputs in `products/`
(checkpoint.npz + anchors.bin + config.json), the JAX package's layout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

def _workspace(name: str) -> str:
    return os.path.join(os.environ.get("MASKRCNN_HOME", ".maskrcnn"),
                        "models", name)


def _load_config(path: str | None, name: str):
    from maskrcnn_tpu_torch.core.config import MaskRCNNConfig

    if path is None:
        path = os.path.join(_workspace(name), "config.json")
    if os.path.exists(path):
        return MaskRCNNConfig.from_json(path)
    print(f"# no config at {path}; using defaults (resnet101, 1024², 81 "
          "classes)", file=sys.stderr)
    return MaskRCNNConfig()


def _build_detector(name: str, config_path, weights_path, products_dir=None,
                    exact: bool = False, device=None, data_parallel: int = 0):
    """The detector of a workspace: its config, then its converted
    checkpoint, else its `weights.h5`, else random weights. `device`
    None is the card; `data_parallel` splits each batch over that many
    devices of its kind (-1: all)."""
    from maskrcnn_tpu_torch.pipeline.detector import MaskRCNNDetector

    config = _load_config(config_path, name)
    if exact:
        config = config.exact_numerics()
        print("# --exact: float32 compute, exact top-k, table anchors",
              file=sys.stderr)
    products = products_dir or os.path.join(_workspace(name), "products")
    ckpt = os.path.join(products, "checkpoint.npz")
    if weights_path is None:
        if os.path.exists(ckpt):
            weights_path = ckpt
        else:
            h5 = os.path.join(_workspace(name), "weights.h5")
            weights_path = h5 if os.path.exists(h5) else None
    if weights_path is None:
        print("# WARNING: no weights found — using random init",
              file=sys.stderr)
        det = MaskRCNNDetector.from_random(config, device=device)
    else:
        print(f"# loading weights: {weights_path}", file=sys.stderr)
        det = MaskRCNNDetector.from_checkpoint(config, weights_path,
                                               device=device)
    if data_parallel:
        det = MaskRCNNDetector(config, det.params, device=det.device,
                               data_parallel=data_parallel)
        print(f"# data parallel over {len(det.devices)} devices",
              file=sys.stderr)
    print(f"# device: {det.device}", file=sys.stderr)
    return det, config


def _device_name(device) -> str:
    import torch

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


# ---------------------------------------------------------------------------
# convert
# ---------------------------------------------------------------------------

def cmd_convert(args) -> int:
    import numpy as np
    import torch

    from maskrcnn_tpu_torch.core.anchors import (generate_anchors,
                                                 save_anchors_bin)
    from maskrcnn_tpu_torch.io.weights import (load_h5_weights,
                                               merge_pretrained,
                                               save_npz_checkpoint)
    from maskrcnn_tpu_torch.models.mask_rcnn import init_mask_rcnn

    config = _load_config(args.config, args.name)
    weights = args.weights or os.path.join(_workspace(args.name),
                                           "weights.h5")
    out_dir = args.output_dir or os.path.join(_workspace(args.name),
                                              "products")
    os.makedirs(out_dir, exist_ok=True)

    init = init_mask_rcnn(torch.Generator().manual_seed(0), config)
    t0 = time.time()
    loaded = load_h5_weights(weights)
    params, missing, unused = merge_pretrained(
        init, loaded, strict=not args.allow_missing)
    print(f"# loaded {len(loaded)} layers in {time.time()-t0:.1f}s "
          f"({len(unused)} unused, {len(missing)} missing)", file=sys.stderr)

    ckpt_dtype = np.float16 if args.fp16 else np.float32
    save_npz_checkpoint(params, os.path.join(out_dir, "checkpoint.npz"),
                        dtype=ckpt_dtype)
    anchors = generate_anchors(config)
    save_anchors_bin(anchors, os.path.join(out_dir, "anchors.bin"))
    config.to_json(os.path.join(out_dir, "config.json"))
    print(f"products written to {out_dir}: checkpoint.npz"
          f"{' (fp16)' if args.fp16 else ''}, anchors.bin "
          f"({anchors.shape[0]} anchors), config.json")

    if args.export_savedmodel:
        from maskrcnn_tpu_torch.io.export import export_program, verify_program
        from maskrcnn_tpu_torch.models.mask_rcnn import resolve_device

        device = resolve_device(args.device)
        program_dir = args.export_savedmodel
        t0 = time.time()
        export_program(params, config, program_dir, batch=args.export_batch,
                       device=device)
        diff = verify_program(program_dir, params, config,
                              batch=args.export_batch, device=device)
        print(f"torch.export program written to {program_dir} in "
              f"{time.time()-t0:.1f}s (batch {args.export_batch}, "
              f"{_device_name(device)}; reload-vs-eager max |diff| "
              f"{diff:.2e})")
        if diff > 1e-4:
            # at random weights a near-tie detection can flip between two
            # kernel libraries; trained weights have wide margins
            print("# WARNING: the reloaded program differs from the eager "
                  "forward beyond 1e-4", file=sys.stderr)
            if args.strict_export:
                print("# --strict-export: failing on reload mismatch",
                      file=sys.stderr)
                return 1
    return 0


# ---------------------------------------------------------------------------
# evaluate
# ---------------------------------------------------------------------------

def _tensorflow_imports() -> bool:
    """Whether `--compare-tf` can run; the reason printed where not."""
    try:
        import tensorflow  # noqa: F401
    except ImportError as e:
        print(f"error: evaluate --compare-tf runs the TensorFlow oracle "
              f"(evalkit/tf_forward.py), but TensorFlow does not import "
              f"here ({e}); install TensorFlow or drop --compare-tf",
              file=sys.stderr)
        return False
    return True


def cmd_evaluate(args) -> int:
    # the oracle is checked first: --compare-tf never runs without it
    if args.compare_tf and not _tensorflow_imports():
        return 2
    import numpy as np

    from maskrcnn_tpu_torch.evalkit.coco import COCODataset
    from maskrcnn_tpu_torch.evalkit.cocoeval import COCOEvaluator
    from maskrcnn_tpu_torch.evalkit.results import (
        build_results_proto, detections_to_coco_results, load_coco_results,
        save_coco_results, save_results_proto)
    from maskrcnn_tpu_torch.pipeline.loader import PrefetchLoader
    from maskrcnn_tpu_torch.pipeline.preprocess import quantize_canvas_u8
    from maskrcnn_tpu_torch.utils.profiling import StageTimer

    timer = StageTimer()
    detector, config = _build_detector(args.model, args.config, args.weights,
                                       args.products_dir, exact=args.exact,
                                       device=args.device,
                                       data_parallel=args.dp)
    ann_dir = args.annotations_dir or os.path.join("data", args.dataset)
    dataset = COCODataset.from_dir(ann_dir, args.type, args.year)
    images_dir = args.images_dir or os.path.join(
        "data", args.dataset, f"{args.type}{args.year}")

    rows = []
    per_image = {}
    times = []
    eval_ids = []
    pending, pending_ids = [], []

    def flush():
        if not pending:
            return
        t0 = time.time()
        # --uint8 quantizes the canvases for the copy to the card: 4x
        # fewer bytes. Host work, charged outside the inference phase.
        canvases = [c for c, _ in pending]
        if args.uint8:
            canvases = [quantize_canvas_u8(c) for c in canvases]
        with timer.phase("inference"):
            # "rle": region paste + O(box area) encode per detection
            all_dets = detector.detect_canvases(
                canvases, [w for _, w in pending],
                batch_size=args.batch, paste_masks="rle")
        dt = (time.time() - t0) / len(pending)
        for img_id, dets in zip(pending_ids, all_dets):
            times.append(dt)
            print(f"image {img_id}: {len(dets)} detections in "
                  f"{dt*1000:.1f} ms", file=sys.stderr)
            with timer.phase("results"):
                rows.extend(
                    detections_to_coco_results(img_id, dets, dataset))
            per_image[img_id] = dets
            eval_ids.append(img_id)
        pending.clear()
        pending_ids.clear()

    eval_paths: dict[int, str] = {}   # read again by --compare-tf

    def iter_paths():
        for im in dataset.iter_images(limit=args.limit, sort_by_id=True):
            path = os.path.join(images_dir, im.file_name)
            if not os.path.exists(path):
                print(f"# skipping {im.id}: {path} not found",
                      file=sys.stderr)
                continue
            eval_paths[im.id] = path
            yield im.id, path

    loader = iter(PrefetchLoader(iter_paths(), config.image_height,
                                 depth=max(2 * args.batch, 4)))
    while True:
        # time blocked on decode: ~0 while the prefetch pool keeps ahead
        with timer.phase("load+decode"):
            item = next(loader, None)
        if item is None:
            break
        img_id, canvas, win = item
        pending.append((canvas, win))
        pending_ids.append(img_id)
        if len(pending) >= args.batch:
            flush()
    flush()
    if not eval_ids:
        print("no images evaluated (missing files?)", file=sys.stderr)
        return 1

    os.makedirs(args.results_dir, exist_ok=True)
    save_coco_results(rows, os.path.join(args.results_dir, "results.json"))
    save_results_proto(build_results_proto(per_image, dataset),
                       os.path.join(args.results_dir, "results.pb"))
    print(f"# {len(eval_ids)} images on {_device_name(detector.device)}, "
          f"median {np.median(times)*1000:.1f} ms/img", file=sys.stderr)
    print("# phase breakdown:\n" + timer.report(), file=sys.stderr)

    for iou_type in ("bbox", "segm"):
        print(f"== {iou_type} ==")
        COCOEvaluator(dataset, rows, iou_type, img_ids=eval_ids).summarize()

    if args.compare:
        print(f"== comparison results: {args.compare} ==")
        other = load_coco_results(args.compare)
        has_segm = any("segmentation" in r for r in other)
        for iou_type in ("bbox", "segm"):
            if iou_type == "segm" and not has_segm:
                continue
            print(f"== {iou_type} (compare) ==")
            COCOEvaluator(dataset, other, iou_type,
                          img_ids=eval_ids).summarize()

    if args.compare_tf:
        _compare_tf(args, detector, config, dataset, eval_ids, eval_paths)
    return 0


def _compare_tf(args, detector, config, dataset, eval_ids, eval_paths):
    """The reference's `-c` mode (EvaluateCommand.swift:124-127): the same
    weights through the independent TensorFlow implementation, in float32
    on the host CPU, over the same letterboxed images; its results go to
    `results_tf.json` beside `results.json`, and both AP tables print."""
    import numpy as np

    from maskrcnn_tpu_torch.core.anchors import generate_anchors
    from maskrcnn_tpu_torch.evalkit.cocoeval import COCOEvaluator
    from maskrcnn_tpu_torch.evalkit.results import (
        detections_to_coco_results, save_coco_results)
    from maskrcnn_tpu_torch.evalkit.tf_forward import tf_forward
    from maskrcnn_tpu_torch.io.weights import params_to_numpy
    from maskrcnn_tpu_torch.pipeline.loader import load_letterboxed

    print("== TensorFlow oracle (same weights, independent "
          "implementation) ==", file=sys.stderr)
    params_np = params_to_numpy(detector.params)
    anchors_np = generate_anchors(config)
    tf_rows = []
    for img_id in eval_ids:
        canvas, win = load_letterboxed(eval_paths[img_id], config.image_height)
        res = tf_forward(params_np, canvas[None], anchors_np, config)[0]
        d = len(res["scores"])
        det_rows = np.concatenate(
            [res["boxes"], res["class_ids"][:, None].astype(np.float32),
             res["scores"][:, None]], axis=1) if d else np.zeros((0, 6))
        dets = detector.unmold(det_rows, res["masks"], np.ones((d,), bool),
                               win, paste_masks="rle")
        tf_rows.extend(detections_to_coco_results(img_id, dets, dataset))
    save_coco_results(tf_rows,
                      os.path.join(args.results_dir, "results_tf.json"))
    for iou_type in ("bbox", "segm"):
        print(f"== {iou_type} (TF oracle) ==")
        COCOEvaluator(dataset, tf_rows, iou_type,
                      img_ids=eval_ids).summarize()


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def cmd_train(args) -> int:
    """Training on a COCO-format dataset, or `--synthetic` for a
    self-contained overfit run on one fixed random batch."""
    import numpy as np
    import torch

    from maskrcnn_tpu_torch.core.anchors import generate_anchors
    from maskrcnn_tpu_torch.io.weights import save_npz_checkpoint
    from maskrcnn_tpu_torch.models.mask_rcnn import (init_mask_rcnn,
                                                     params_to,
                                                     resolve_device)
    from maskrcnn_tpu_torch.train.checkpoint import (CheckpointManager,
                                                     MetricsLogger,
                                                     restore_train_state,
                                                     save_train_state)
    from maskrcnn_tpu_torch.train.data import (COCOTrainLoader,
                                               PrefetchBatcher,
                                               synthetic_train_batch)
    from maskrcnn_tpu_torch.train.step import make_train_state, train_step

    device = resolve_device(args.device)
    config = _load_config(args.config, args.model)
    if args.exact:
        config = config.exact_numerics()
        print("# --exact: float32 compute, exact top-k, table anchors",
              flush=True)
    if args.train_bn:
        config = config.replace(train_bn=args.train_bn)
    if args.remat:
        config = config.replace(train_remat_backbone=True)
    if args.bf16_momentum:
        config = config.replace(train_momentum_dtype="bfloat16")
    if args.synthetic:
        config = config.replace(
            architecture="resnet50",
            input_image_shape=(args.image_size, args.image_size, 3),
            num_classes=5,
            anchor_scales=tuple(args.image_size / 16 * s
                                for s in (1, 2, 4, 8, 16)),
            pre_nms_max_proposals=256, max_proposals=64, max_detections=16,
            train_rois_per_image=32, rpn_train_anchors_per_image=64)
    print(f"# device: {_device_name(device)}", flush=True)

    params = params_to(init_mask_rcnn(
        torch.Generator().manual_seed(args.seed), config), device)
    anchors = torch.from_numpy(generate_anchors(config)).to(device)
    state, opt = make_train_state(params, config, trainable=args.trainable)

    batcher = None
    if args.synthetic:
        fixed = synthetic_train_batch(config, args.batch, device,
                                      seed=args.seed, gt=4)
        loader = lambda step: fixed  # noqa: E731 (fixed-batch overfit)
    else:
        # --exact keeps the resampled float32 canvas; otherwise uint8
        # canvases, 4x fewer host-to-device bytes
        batcher = PrefetchBatcher(COCOTrainLoader(
            args.annotations, args.images_dir, config,
            batch_size=args.batch, seed=args.seed, flip_prob=args.flip_prob,
            cache_images=args.cache_images,
            image_dtype=np.float32 if args.exact else np.uint8))
        loader = batcher.get_batch

    try:
        manager = (CheckpointManager(args.checkpoint_dir, keep=args.keep)
                   if args.checkpoint_dir else None)
        if args.resume:
            restored = (manager.restore_latest(state)
                        if manager is not None else None)
            if restored is not None:
                state = restored
                print(f"resumed from {args.checkpoint_dir} at step "
                      f"{state.step}")
            elif args.state and os.path.exists(args.state):
                # an empty --checkpoint-dir falls back to --state
                state = restore_train_state(state, args.state)
                print(f"resumed from {args.state} at step {state.step}")
            else:
                print("# --resume: no checkpoint found, starting fresh",
                      file=sys.stderr)

        mlog = MetricsLogger(args.metrics_log)
        t0 = time.time()
        start_step = state.step
        end_step = start_step + args.steps
        if args.resume and start_step > 0:
            # --steps is the TOTAL budget under --resume: an interrupted run
            # finishes its plan instead of training N more steps
            end_step = max(args.steps, start_step)
            print(f"# --resume: continuing to total step {end_step}")
            if start_step >= end_step:
                print(f"# WARNING: checkpoint is already at step "
                      f"{start_step} >= --steps {args.steps}; no step "
                      "runs. --steps is the TOTAL budget under --resume: "
                      "raise it to train further.", file=sys.stderr)
        for step in range(start_step, end_step):
            # the sampling draws of step s come from (seed + 1, s), so a
            # resumed run draws what an uninterrupted one does
            state, metrics = train_step(state, loader(step), anchors, config,
                                        opt, seed=args.seed + 1)
            if step % args.log_every == 0 or step == end_step - 1:
                shown = {k: round(float(v), 4) for k, v in metrics.items()}
                print(f"step {step:5d}  {shown}  ({time.time() - t0:.1f}s)")
                mlog.log(step, metrics, time.time() - t0)
            if (manager is not None and args.checkpoint_every
                    and (step + 1) % args.checkpoint_every == 0):
                manager.save(state)
        if manager is not None:
            path = manager.save(state)
            manager.wait()
            print(f"train state saved: {path} (step {state.step})")
        if args.state:
            save_train_state(state, args.state)
            print(f"train state saved: {args.state} (step {state.step})")
        params_out = state.params
        if config.train_bn == "batch" and not args.no_calibrate:
            # batch-statistic training never touches the moving
            # statistics: re-estimate them for the inference path
            from maskrcnn_tpu_torch.train.calibrate import calibrate_bn_stats
            cal = [loader(i)["images"] for i in range(args.calibrate_batches)]
            params_out = calibrate_bn_stats(params_out, cal, anchors, config)
            print(f"BN statistics calibrated over {len(cal)} batches")
        if args.output:
            save_npz_checkpoint(params_out, args.output)
            print(f"checkpoint saved: {args.output}")
    finally:
        if batcher is not None:
            batcher.close()  # cancel the dangling one-ahead prefetch
    return 0


# ---------------------------------------------------------------------------
# download
# ---------------------------------------------------------------------------

def cmd_download(args) -> int:
    """Fetch pretrained weights.h5 into the workspace; `--url` may name a
    local file (a mirror on a host without network), which is copied."""
    import urllib.error
    import urllib.request

    dest = _workspace(args.name)
    os.makedirs(dest, exist_ok=True)
    url = args.url or ("https://github.com/matterport/Mask_RCNN/releases/"
                       "download/v2.0/mask_rcnn_coco.h5")
    out = os.path.join(dest, "weights.h5")
    if args.url and os.path.exists(args.url):
        import shutil

        shutil.copyfile(args.url, out)
        print(f"copied local artifact {args.url} -> {out}")
        return 0
    print(f"downloading {url} -> {out}")
    try:
        with urllib.request.urlopen(url, timeout=args.timeout) as r, \
                open(out + ".part", "wb") as f:
            while True:
                chunk = r.read(1 << 20)
                if not chunk:
                    break
                f.write(chunk)
        os.replace(out + ".part", out)
        print("done")
        return 0
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        print(f"download failed ({e}); this environment may have no network "
              f"egress. Place weights.h5 under {dest}/ manually.",
              file=sys.stderr)
        return 1


# ---------------------------------------------------------------------------
# stream
# ---------------------------------------------------------------------------

def cmd_stream(args) -> int:
    """Streaming video inference (`pipeline/stream.run_stream`)."""
    import numpy as np
    import torch

    from maskrcnn_tpu_torch.pipeline.preprocess import quantize_canvas_u8
    from maskrcnn_tpu_torch.pipeline.stream import (forward_batch,
                                                    frames_from_dir,
                                                    run_stream,
                                                    synthetic_frames)

    detector, config = _build_detector(args.model, args.config, args.weights,
                                       None, exact=args.exact,
                                       device=args.device)
    size = config.image_height
    if args.frames_dir:
        frames = frames_from_dir(args.frames_dir, size)
    else:
        frames = synthetic_frames(args.num_frames, size)

    # warm-up off the clock, uint8 as run_stream ships frames (on one card
    # this captures the stream's CUDA graph); with --device-paste the
    # full-resolution paste runs inside the forward
    paste_size = size if args.device_paste else None
    forward_batch(detector, np.zeros((args.micro_batch, size, size, 3),
                                     np.uint8), args.micro_batch, paste_size)

    valid_refs = []  # device references only: no readback on the hot path

    def on_result(i, out):
        valid_refs.append(out["valid"])

    if args.device_frames:
        # micro-batches staged on the device first: the host-to-device copy
        # leaves the timed loop
        staged, buf = [], []
        for f in frames:
            buf.append(quantize_canvas_u8(f))
            if len(buf) == args.micro_batch:
                staged.append(torch.from_numpy(np.stack(buf))
                              .to(detector.device))
                buf = []
        if buf:
            staged.append(torch.from_numpy(np.stack(buf))
                          .to(detector.device))
        if staged:
            staged[-1].reshape(-1)[0].item()
        stats = run_stream(detector, staged, on_result=on_result,
                           micro_batch=args.micro_batch, prebatched=True,
                           paste_size=paste_size)
    else:
        stats = run_stream(detector, frames, on_result=on_result,
                           micro_batch=args.micro_batch,
                           paste_size=paste_size)
    counts = [int(v.sum()) for v in valid_refs]  # off the clock
    print(f"{stats.frames} frames in {stats.wall_s:.2f}s -> "
          f"{stats.fps:.1f} fps, latency p50 {stats.p50_latency_ms:.1f} / "
          f"p95 {stats.p95_latency_ms:.1f} / p99 {stats.p99_latency_ms:.1f} "
          f"ms ({stats.latency_probes} probes), detections per microbatch: "
          f"{counts[:8]}{'...' if len(counts) > 8 else ''}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({
                "metric": f"stream_fps_{config.architecture}_"
                          f"{config.image_height}",
                "frames": stats.frames,
                "micro_batch": args.micro_batch,
                "device_paste": bool(args.device_paste),
                "device_frames": bool(args.device_frames),
                "wall_s": stats.wall_s,
                "fps": stats.fps,
                "p50_latency_ms": stats.p50_latency_ms,
                "p95_latency_ms": stats.p95_latency_ms,
                "p99_latency_ms": stats.p99_latency_ms,
                "latency_probes": stats.latency_probes,
                "device": _device_name(detector.device),
            }, f, indent=1)
        print(f"# wrote {args.json}", file=sys.stderr)
    return 0


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

def cmd_serve(args) -> int:
    """HTTP model server with dynamic micro-batching (pipeline/serve.py)."""
    import numpy as np

    from maskrcnn_tpu_torch.pipeline.serve import make_server

    detector, config = _build_detector(args.model, args.config, args.weights,
                                       None, exact=args.exact,
                                       device=args.device)
    size = config.image_height
    # uint8 wire by default (request pixels are 8-bit); --exact keeps
    # float32 canvases end to end
    uint8_wire = not args.exact
    wire_dtype = np.uint8 if uint8_wire else np.float32
    detector.run_batch(np.zeros((args.max_batch, size, size, 3),
                                wire_dtype))          # warm-up

    server, worker = make_server(detector, host=args.host, port=args.port,
                                 max_batch=args.max_batch,
                                 window_ms=args.window_ms,
                                 uint8_wire=uint8_wire)
    host, port = server.server_address[:2]
    print(f"# serving on http://{host}:{port}  "
          f"(POST /detect, GET /healthz; batch<={args.max_batch}, "
          f"window {args.window_ms} ms)", file=sys.stderr)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        worker.stop()
        server.server_close()
    return 0


# ---------------------------------------------------------------------------
# demo
# ---------------------------------------------------------------------------

def cmd_demo(args) -> int:
    from PIL import Image

    from maskrcnn_tpu_torch.core.coco_names import class_name
    from maskrcnn_tpu_torch.pipeline.loader import decode_rgb
    from maskrcnn_tpu_torch.utils.render import render_detections

    detector, config = _build_detector(args.model, args.config, args.weights,
                                       None, exact=args.exact,
                                       device=args.device)
    img = decode_rgb(args.image)
    t0 = time.time()
    dets = detector.detect_images([img])[0]
    print(f"{len(dets)} detections in {(time.time()-t0)*1000:.0f} ms "
          f"on {_device_name(detector.device)}")
    names = [class_name(i, config.num_classes)
             for i in range(config.num_classes)]
    for d in dets:
        print(f"  {names[d.class_id]}  score {d.score:.3f}  box "
              f"({d.box[0]:.0f},{d.box[1]:.0f},{d.box[2]:.0f},{d.box[3]:.0f})")
    out = args.output or "detections.png"
    Image.fromarray(render_detections(img, dets, class_names=names)).save(out)
    print(f"rendered: {out}")
    return 0


# ---------------------------------------------------------------------------

def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card; "
                        "'cpu' runs the plain PyTorch path)")


_EXACT_HELP = ("reference-exact numerics: float32 + exact top-k + table "
               "anchors")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="maskrcnn_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    c = sub.add_parser("convert", help="weights.h5 -> products/ artifacts")
    c.add_argument("name")
    c.add_argument("--config")
    c.add_argument("--weights")
    c.add_argument("--output_dir")
    c.add_argument("--allow-missing", action="store_true")
    c.add_argument("--export-savedmodel", metavar="DIR",
                   help="also write the whole forward (weights, anchors "
                        "and preprocess baked in) to DIR as a torch.export "
                        "program (model.pt2 + config.json; load it after "
                        "`import maskrcnn_tpu_torch.ops`), traced on "
                        "--device and checked against the eager forward "
                        "on reload")
    c.add_argument("--export-batch", type=int, default=1,
                   help="static batch size of the exported program")
    c.add_argument("--strict-export", action="store_true",
                   help="exit nonzero if the reloaded program differs "
                        "from the eager forward beyond 1e-4 (default only "
                        "warns)")
    c.add_argument("--fp16", action="store_true",
                   help="store checkpoint weights as float16; upcast to "
                        "float32 at load")
    _add_device(c)
    c.set_defaults(fn=cmd_convert)

    e = sub.add_parser("evaluate", help="COCO evaluation (bbox + mask AP)")
    e.add_argument("model")
    e.add_argument("dataset")
    e.add_argument("--year", default="2017")
    e.add_argument("--type", default="val")
    e.add_argument("--limit", type=int, default=5,
                   help="images to evaluate (reference hardcodes 5)")
    e.add_argument("--batch", type=int, default=1,
                   help="inference batch size (reference is batch=1)")
    e.add_argument("--dp", type=int, default=0,
                   help="split each batch over N devices of --device's "
                        "kind (0 = one device, -1 = all)")
    e.add_argument("--config")
    e.add_argument("--weights")
    e.add_argument("--products_dir")
    e.add_argument("--annotations_dir")
    e.add_argument("--images_dir")
    e.add_argument("--results_dir", default=".maskrcnn/tmp")
    e.add_argument("-c", "--compare", metavar="RESULTS_JSON",
                   help="also score another results file side by side")
    e.add_argument("--uint8", action="store_true",
                   help="ship uint8 canvases to the card (+-0.5 of a "
                        "level): 4x fewer host-to-device bytes")
    e.add_argument("--exact", action="store_true", help=_EXACT_HELP)
    e.add_argument("--compare-tf", action="store_true",
                   help="also run the same weights through the TensorFlow "
                        "oracle (float32, host CPU) and score it: "
                        "results_tf.json; exits 2 without TensorFlow")
    _add_device(e)
    e.set_defaults(fn=cmd_evaluate)

    t = sub.add_parser("train", help="train on a COCO dataset or "
                                      "--synthetic data")
    t.add_argument("model")
    t.add_argument("--config")
    t.add_argument("--annotations", help="COCO instances json")
    t.add_argument("--images_dir")
    t.add_argument("--synthetic", action="store_true",
                   help="self-contained overfit run on one fixed random "
                        "batch, no dataset needed")
    t.add_argument("--steps", type=int, default=20)
    t.add_argument("--batch", type=int, default=2)
    t.add_argument("--image-size", type=int, default=128,
                   help="with --synthetic")
    t.add_argument("--trainable", default="all",
                   help="all|heads|3+|4+|5+ or a layer-name regex")
    t.add_argument("--train-bn", choices=("batch", "frozen"),
                   help="override config.train_bn: 'batch' = from-scratch "
                        "recipe (live batch statistics, calibrated after "
                        "training); 'frozen' = Matterport fine-tuning "
                        "(stored statistics, every BN layer frozen)")
    t.add_argument("--remat", action="store_true",
                   help="recompute the backbone + FPN in the backward "
                        "(config.train_remat_backbone): less activation "
                        "memory for one more backbone forward")
    t.add_argument("--bf16-momentum", action="store_true",
                   help="store the SGD momentum trace in bfloat16 "
                        "(config.train_momentum_dtype): half the optimizer "
                        "state; params and the update stay float32")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--log-every", type=int, default=5)
    t.add_argument("--output", help="write the final checkpoint.npz here")
    t.add_argument("--state", help="train-state file for save/resume")
    t.add_argument("--no-calibrate", action="store_true",
                   help="skip the BN statistics calibration after "
                        "batch-BN training")
    t.add_argument("--calibrate-batches", type=int, default=8)
    t.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint-dir (latest) or --state; "
                        "--steps then counts as the TOTAL budget")
    t.add_argument("--checkpoint-dir",
                   help="directory for periodic ckpt_<step>.pt saves")
    t.add_argument("--checkpoint-every", type=int, default=0,
                   help="save every N steps (0 = only at the end)")
    t.add_argument("--keep", type=int, default=3,
                   help="checkpoints to keep in --checkpoint-dir")
    t.add_argument("--metrics-log",
                   help="append JSONL training metrics to this file")
    t.add_argument("--flip-prob", type=float, default=0.5,
                   help="horizontal-flip probability (Matterport's "
                        "Fliplr(0.5); 0 disables)")
    t.add_argument("--exact", action="store_true",
                   help="reference-exact numerics in training too: float32 "
                        "compute, exact top-k, table anchors, float32 "
                        "canvases")
    t.add_argument("--cache-images", type=int, default=0,
                   help="keep up to N decoded examples in host memory (the "
                        "first N distinct images seen; 0 disables)")
    _add_device(t)
    t.set_defaults(fn=cmd_train)

    d = sub.add_parser("download", help="fetch pretrained weights")
    d.add_argument("name")
    d.add_argument("--url")
    d.add_argument("--timeout", type=float, default=30.0)
    d.set_defaults(fn=cmd_download)

    st = sub.add_parser("stream", help="streaming inference (video frames)")
    st.add_argument("model")
    st.add_argument("--frames-dir", help="directory of frames (else synthetic)")
    st.add_argument("--num-frames", type=int, default=64)
    st.add_argument("--micro-batch", type=int, default=1)
    st.add_argument("--device-paste", action="store_true",
                    help="paste full-resolution masks on the card per frame")
    st.add_argument("--device-frames", action="store_true",
                    help="stage the frames on the card first (the "
                         "host-to-device copy leaves the timed loop)")
    st.add_argument("--exact", action="store_true", help=_EXACT_HELP)
    st.add_argument("--json", help="write a stats JSON artifact here")
    st.add_argument("--config")
    st.add_argument("--weights")
    _add_device(st)
    st.set_defaults(fn=cmd_stream)

    sv = sub.add_parser("serve", help="HTTP server w/ dynamic batching")
    sv.add_argument("model")
    sv.add_argument("--config")
    sv.add_argument("--weights")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8389)
    sv.add_argument("--max-batch", type=int, default=8)
    sv.add_argument("--window-ms", type=float, default=5.0)
    sv.add_argument("--exact", action="store_true", help=_EXACT_HELP)
    _add_device(sv)
    sv.set_defaults(fn=cmd_serve)

    m = sub.add_parser("demo", help="detect + render one image")
    m.add_argument("model")
    m.add_argument("image")
    m.add_argument("-o", "--output")
    m.add_argument("--config")
    m.add_argument("--weights")
    m.add_argument("--exact", action="store_true", help=_EXACT_HELP)
    _add_device(m)
    m.set_defaults(fn=cmd_demo)

    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
