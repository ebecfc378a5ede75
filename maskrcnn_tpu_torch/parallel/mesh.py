"""Data parallelism over devices, port of `maskrcnn_tpu/parallel/mesh.py`.

Inference is one process driving every device, as the JAX package's
single-controller mesh: the params replicated on each device, the batch
cut into equal shards, each shard's `forward` on its own device, and the
outputs gathered in batch order (no image depends on another, so nothing
crosses between devices). On the CPU a "mesh" is the CPU listed n times,
the analog of the JAX package's virtual host devices.

Training runs one process per device over `torch.distributed` (NCCL on
cards, gloo on the CPU): each rank holds one shard of the global batch and
the step equals the single-device step over the whole batch, as GSPMD's
does. The sampling draws are the global batch's, drawn on every rank
from `step_generator(seed, step)`, and each rank takes its rows; batch
statistics and the head losses' means span the ranks (the process group
goes to `compute_gradients`, which hands it to BN in `bn_ctx` and to the
losses); the gradients are summed over the ranks as one flat buffer and
every rank applies the same optimizer step.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from maskrcnn_tpu_torch.utils.profiling import stage


def make_mesh(n_devices: int | None = None,
              device_type: str = "cuda") -> list[torch.device]:
    """The first `n_devices` devices of `device_type` (None or -1: all of
    them); raises where fewer are present. The CPU is one device, listed
    `n_devices` times (-1: once)."""
    if device_type == "cpu":
        n = 1 if n_devices in (None, -1) else n_devices
        return [torch.device("cpu")] * n
    have = torch.cuda.device_count() if device_type == "cuda" else 0
    n = have if n_devices in (None, -1) else n_devices
    if n < 1 or have < n:
        raise ValueError(f"requested {n_devices} {device_type} devices, "
                         f"have {have}")
    return [torch.device(device_type, i) for i in range(n)]


def replicate(devices, params) -> list[dict[str, Any]]:
    """One copy of the params on each device (shared where devices
    repeat)."""
    from maskrcnn_tpu_torch.models.mask_rcnn import params_to
    return [params_to(params, d) for d in devices]


def shard_batch(devices, images) -> list[torch.Tensor]:
    """A batch (leading axis divisible by the device count) cut into equal
    shards, shard i on device i."""
    images = torch.as_tensor(images)
    n = len(devices)
    if images.shape[0] % n:
        raise ValueError(f"batch of {images.shape[0]} does not split over "
                         f"{n} devices")
    with stage("mesh.copy_in"):
        return [x.to(d) for x, d in zip(images.chunk(n), devices)]


def data_parallel_forward(devices, config, replicas, images,
                          paste_size: int | None = None
                          ) -> dict[str, torch.Tensor]:
    """DP batch inference: each shard's `forward` on its device with its
    copy of the params (`replicas = replicate(devices, params)`), the
    outputs gathered on the first device in batch order (one device: its
    outputs as they are)."""
    from maskrcnn_tpu_torch.models.mask_rcnn import forward
    outs = [forward(p, x, config, device=d, paste_size=paste_size)
            for p, x, d in zip(replicas, shard_batch(devices, images),
                               devices)]
    if len(outs) == 1:
        return outs[0]
    return {k: torch.cat([o[k].to(devices[0]) for o in outs])
            for k in outs[0]}


def broadcast_state(state, group=None):
    """Every rank's params and momentum set to rank 0's (in place); the
    start of data-parallel training."""
    for tree in (state.params, state.momentum):
        for ws in tree.values():
            for t in ws.values():
                dist.broadcast(t, src=dist.get_global_rank(
                    group or dist.group.WORLD, 0), group=group)
    return state


def data_parallel_train_step(config, opt, group=None):
    """The DP training step over the ranks of `group` (default: the world):
    step(state, batch, anchors, seed=0, draws=None) -> (new state,
    metrics), `batch` this rank's equal shard of the global batch, `state`
    the same on every rank (`broadcast_state`), `draws` the global batch's
    (`draw_uniforms`' layout; default: drawn from `step_generator(seed,
    state.step)`), of which each rank takes its rows. The metrics are the
    global batch's."""
    from maskrcnn_tpu_torch.train.step import (apply_gradients,
                                               compute_gradients,
                                               draw_uniforms, step_generator)

    g = dist.group.WORLD if group is None else group

    def step(state, batch, anchors, *, seed: int = 0, draws=None):
        world = dist.get_world_size(g)
        rank = dist.get_rank(g)
        first = next(iter(next(iter(state.params.values())).values()))
        dev = first.device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        anchors = torch.as_tensor(anchors).to(dev, torch.float32)
        b, n_gt = batch["gt_boxes"].shape[:2]
        if draws is None:
            draws = draw_uniforms(step_generator(seed, state.step, dev),
                                  b * world, anchors.shape[0],
                                  config.max_proposals + n_gt, dev)
        draws = {k: torch.as_tensor(v)[rank * b:(rank + 1) * b].to(dev)
                 for k, v in draws.items()}
        grads, metrics = compute_gradients(state, batch, anchors, config,
                                           opt, draws=draws, group=g)
        names = [(layer, w) for layer, ws in state.params.items()
                 for w in ws]
        flat = torch.cat([
            (torch.zeros_like(state.params[layer][w])
             if grads.get(layer, {}).get(w) is None
             else grads[layer][w]).reshape(-1).to(torch.float32)
            for layer, w in names])
        dist.all_reduce(flat, group=g)
        summed: dict = {}
        offset = 0
        for layer, w in names:
            p = state.params[layer][w]
            summed.setdefault(layer, {})[w] = \
                flat[offset:offset + p.numel()].view(p.shape)
            offset += p.numel()
        keys = sorted(metrics)
        total = torch.stack([metrics[k].to(torch.float32) for k in keys])
        dist.all_reduce(total, group=g)
        return (apply_gradients(state, summed, opt),
                dict(zip(keys, total.unbind())))

    return step


def _dryrun_batch(config, b: int) -> dict[str, np.ndarray]:
    """The JAX package's dry-run batch: 4 GT boxes an image, 28^2 masks."""
    g, m = 4, 28
    rng = np.random.default_rng(0)
    yx1 = rng.uniform(0, 0.6, (b, g, 2))
    wh = rng.uniform(0.1, 0.3, (b, g, 2))
    return {
        "images": rng.uniform(0, 255, (b, config.image_height,
                                       config.image_width, 3)).astype(
            np.float32),
        "gt_boxes": np.concatenate([yx1, yx1 + wh], -1).astype(np.float32),
        "gt_class_ids": rng.integers(
            1, config.num_classes, (b, g)).astype(np.int32),
        "gt_masks": (rng.random((b, g, m, m)) > 0.5).astype(np.float32),
    }


def _dryrun_rank(rank: int, n: int, store_path: str,
                 device_type: str) -> None:
    from maskrcnn_tpu_torch.core.anchors import generate_anchors
    from maskrcnn_tpu_torch.core.config import tiny_test_config
    from maskrcnn_tpu_torch.models.mask_rcnn import init_mask_rcnn, params_to
    from maskrcnn_tpu_torch.train.step import make_train_state, train_step

    torch.set_num_threads(1)
    dev = torch.device("cpu")
    if device_type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            store=dist.FileStore(store_path, n),
                            rank=rank, world_size=n)
    try:
        config = tiny_test_config()
        params = params_to(init_mask_rcnn(torch.Generator().manual_seed(0),
                                          config), dev)
        anchors = torch.from_numpy(generate_anchors(config))
        batch = _dryrun_batch(config, n)           # one image per rank
        state0, opt = make_train_state(params, config)
        broadcast_state(state0)
        shard = {k: v[rank:rank + 1] for k, v in batch.items()}
        state, metrics = data_parallel_train_step(config, opt)(
            state0, shard, anchors, seed=1)
        loss = float(metrics["loss"])
        assert np.isfinite(loss), f"non-finite training loss: {metrics}"
        assert state.step == 1
        if rank != 0:
            return
        # DP equivalence, with the JAX package's bounds: the same step on
        # the whole batch in one process
        single, single_metrics = train_step(state0, batch, anchors, config,
                                            opt, seed=1)
        loss_delta = abs(loss - float(single_metrics["loss"]))
        param_delta = max(
            float((state.params[k][w] - single.params[k][w]).abs().max())
            for k in single.params for w in single.params[k])
        assert loss_delta < 5e-2 * max(1.0, abs(loss)), \
            f"DP loss diverges from single-device: {loss_delta}"
        assert param_delta < 1e-4, \
            f"DP params diverge from single-device: {param_delta}"
        devices = make_mesh(n, device_type)
        out = data_parallel_forward(devices, config,
                                    replicate(devices, params),
                                    batch["images"])
        assert out["detections"].shape[0] == n
        print(f"dryrun: DP train loss={loss:.4f}, inference detections "
              f"shape={tuple(out['detections'].shape)} over {n} "
              f"{device_type} ranks; DP-vs-single parity: "
              f"|dloss|={loss_delta:.3g}, max|dparam|={param_delta:.3g}",
              flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_step(n_devices: int, device=None) -> None:
    """One DP training step at `tiny_test_config()`, one image per rank,
    checked against the single-process step with the JAX package's bounds
    (loss 5e-2 relative, params 1e-4); then the DP inference path. The
    ranks are spawned processes meeting at a FileStore (no port). By
    default rank i runs on card i over NCCL, and fewer than `n_devices`
    cards raise; `device="cpu"` runs gloo ranks on the CPU."""
    import torch.multiprocessing as mp
    device_type = torch.device(device or "cuda").type
    make_mesh(n_devices, device_type)              # enough cards, or raise
    if device_type == "cuda":
        from maskrcnn_tpu_torch.ops import cuda_lib
        cuda_lib.load()            # built once here, not by every rank
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_dryrun_rank, args=(n_devices, os.path.join(tmp, "store"),
                                     device_type),
                 nprocs=n_devices, join=True)
