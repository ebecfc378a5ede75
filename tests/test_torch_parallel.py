"""Data parallelism in the port on the CPU (`parallel/mesh.py`), mirroring
`tests/test_parallel.py`: inference over 2 and 4 "devices" (the CPU listed
n times, the analog of the JAX package's virtual host devices) against one
device, the detector's padding of uneven batches in the batch's own dtype;
training over 2 gloo ranks (spawned, meeting at a FileStore) against the
single-process step over the global batch (frozen BN over 2 steps; batch
BN with the JAX package's draws, also against the JAX step), batch-statistic
BN over the ranks against one process over the global batch, and the head
losses' global normalization where the ranks' positive counts differ.

This file imports JAX only inside the functions that the test process
alone runs: the spawned ranks import it."""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from maskrcnn_tpu_torch.core.anchors import generate_anchors
from maskrcnn_tpu_torch.core.config import tiny_test_config
from maskrcnn_tpu_torch.models import mask_rcnn as M
from maskrcnn_tpu_torch.models import nn
from maskrcnn_tpu_torch.parallel import mesh
from maskrcnn_tpu_torch.pipeline import detector
from maskrcnn_tpu_torch.pipeline.detector import MaskRCNNDetector
from maskrcnn_tpu_torch.pipeline.preprocess import compute_window
from maskrcnn_tpu_torch.train import losses as L
from maskrcnn_tpu_torch.train.step import make_train_state, train_step

WORLD = 2
F32 = dict(compute_dtype="float32")
# the exact-f32, frozen-BN config of `tests/test_parallel.py`'s DP step
TRAIN = dict(compute_dtype="float32", train_sampling_topk="exact",
             train_bn="frozen")
# the same with batch statistics, the default `train_bn`
BATCH_BN = dict(TRAIN, train_bn="batch")
JAX_KEY = 11


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and these tests' many small ops slow by 10-20x when each one
    waits on threads the other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(cfg, seed=0):
    return M.init_mask_rcnn(torch.Generator().manual_seed(seed), cfg)


def test_make_mesh():
    assert mesh.make_mesh(4, "cpu") == [torch.device("cpu")] * 4
    assert mesh.make_mesh(-1, "cpu") == [torch.device("cpu")]
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"have {have}"):
        mesh.make_mesh(have + 1, "cuda")
    assert len(mesh.make_mesh(-1, "cuda")) == have if have else True


@pytest.mark.parametrize("n", [2, 4])
def test_dp_forward_matches_single_device(n):
    """4 images over n devices: bit-equal to one device running each shard,
    and within `tests/test_parallel.py`'s bounds of one device running the
    whole batch (other conv batch sizes round differently)."""
    cfg = tiny_test_config().replace(**F32)
    params = _params(cfg)
    images = torch.from_numpy(np.random.default_rng(n).uniform(
        0, 255, (4, 128, 128, 3)).astype(np.float32))
    devices = mesh.make_mesh(n, "cpu")
    out = mesh.data_parallel_forward(devices, cfg,
                                     mesh.replicate(devices, params), images)
    shards = [M.forward(params, x, cfg, device="cpu")
              for x in images.chunk(n)]
    for k, v in out.items():
        assert torch.equal(v, torch.cat([s[k] for s in shards])), k
    single = M.forward(params, images, cfg, device="cpu")
    np.testing.assert_allclose(out["detections"].numpy(),
                               single["detections"].numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(out["valid"].numpy(),
                                  single["valid"].numpy())
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard_batch(devices, images[:n - 1])


def test_detector_data_parallel_matches_single():
    """`MaskRCNNDetector(data_parallel=4)` against one device: 6 images
    padded to 8, the padding sliced off."""
    cfg = tiny_test_config().replace(**F32)
    params = _params(cfg)
    det1 = MaskRCNNDetector(cfg, params, device="cpu")
    det4 = MaskRCNNDetector(cfg, params, device="cpu", data_parallel=4)
    rng = np.random.default_rng(0)
    images = [rng.uniform(0, 255, (97, 128, 3)).astype(np.uint8)
              for _ in range(6)]
    r1 = det1.detect_images(images, paste_masks=False)
    r4 = det4.detect_images(images, paste_masks=False)
    assert len(r1) == len(r4) == 6 and sum(map(len, r1)) > 0
    for a, b in zip(r1, r4):
        assert len(a) == len(b)
        for da, db in zip(a, b):
            assert da.class_id == db.class_id
            np.testing.assert_allclose(da.score, db.score, rtol=1e-5)
            np.testing.assert_allclose(da.box, db.box, rtol=1e-4, atol=1e-3)
    out = det4.run_batch(np.zeros((3, 128, 128, 3), np.float32))
    assert out["detections"].shape == (3, cfg.max_detections, 6)


def test_detector_dp_pads_uint8_as_uint8(monkeypatch):
    """uint8 wire over 4 devices with a batch of 3: the padded batch stays
    uint8, and its results equal one device's on the same uint8 canvases,
    padded the same way (shards of one image each)."""
    cfg = tiny_test_config().replace(**F32)
    params = _params(cfg)
    det = MaskRCNNDetector(cfg, params, device="cpu", data_parallel=4)
    seen = []
    forward = mesh.data_parallel_forward

    def spy(devices, config, replicas, images, paste_size=None):
        seen.append((images.dtype, tuple(images.shape)))
        return forward(devices, config, replicas, images, paste_size)

    monkeypatch.setattr(detector, "data_parallel_forward", spy)
    s = cfg.image_height
    rng = np.random.default_rng(1)
    canvases = [rng.uniform(0, 255, (s, s, 3)).astype(np.float32)
                for _ in range(3)]
    windows = [compute_window(s, s, s)] * 3
    got = det.detect_canvases(canvases, windows, paste_masks=False,
                              uint8_wire=True)
    assert seen == [(torch.uint8, (4, s, s, 3))]
    one = MaskRCNNDetector(cfg, params, device="cpu")
    want = one.detect_canvases(canvases, windows, paste_masks=False,
                               uint8_wire=True, batch_size=1)
    assert [[(d.class_id, d.score, d.box) for d in r] for r in got] == \
        [[(d.class_id, d.score, d.box) for d in r] for r in want]


# --------------------------------------------------------------------------
# training over 2 gloo ranks
# --------------------------------------------------------------------------

def train_batch(cfg, b, seed=0):
    """`tests/test_parallel.py::_train_batch`."""
    g, m = 4, 28
    rng = np.random.default_rng(seed)
    yx1 = rng.uniform(0, 0.6, (b, g, 2))
    wh = rng.uniform(0.1, 0.3, (b, g, 2))
    return {
        "images": rng.uniform(0, 255, (b, cfg.image_height,
                                       cfg.image_width, 3)).astype(
            np.float32),
        "gt_boxes": np.concatenate([yx1, yx1 + wh], -1).astype(np.float32),
        "gt_class_ids": rng.integers(1, cfg.num_classes, (b, g)).astype(
            np.int32),
        "gt_masks": (rng.random((b, g, m, m)) > 0.5).astype(np.float32),
    }


def bn_case():
    """A BN layer's global input (4 images), params and cotangent."""
    rng = np.random.default_rng(3)
    c = 8
    x = (rng.standard_normal((4, 5, 6, c)) * 2 + 1).astype(np.float32)
    p = {"gamma": rng.uniform(0.5, 1.5, c), "beta": rng.uniform(-.3, .3, c),
         "moving_mean": np.zeros(c), "moving_variance": np.ones(c)}
    p = {k: torch.tensor(v, dtype=torch.float32) for k, v in p.items()}
    return torch.from_numpy(x), p, torch.from_numpy(
        rng.standard_normal(x.shape).astype(np.float32))


def bn_grads(x, p, cot, group=None):
    """y = batch_norm(x) with batch statistics (over the ranks of `group`)
    and d(sum(y * cot)) / d(x, gamma, beta)."""
    x = x.clone().requires_grad_(True)
    q = {k: v.clone().requires_grad_(k in ("gamma", "beta"))
         for k, v in p.items()}
    y = nn.batch_norm(x, q, use_batch_stats=True, group=group)
    gx, gg, gb = torch.autograd.grad((y * cot).sum(),
                                     [x, q["gamma"], q["beta"]])
    return y.detach(), gx, gg, gb


def head_loss_case():
    """Global head-loss inputs of 2 ranks x 8 ROIs: 3 positives on rank 0,
    1 on rank 1 (and 5 vs 6 valid rows)."""
    rng = np.random.default_rng(4)
    t, nc = 16, 5
    class_ids = np.zeros(t, np.int64)
    class_ids[[0, 2, 5, 12]] = [1, 3, 2, 4]
    valid = np.ones(t, bool)
    valid[[6, 7, 9]] = False
    return {"logits": rng.standard_normal((t, nc)),
            "class_ids": class_ids, "valid": valid,
            "pred_deltas": rng.standard_normal((t, nc, 4)),
            "target_deltas": rng.standard_normal((t, 4)),
            "pred_masks": rng.uniform(0.05, 0.95, (t, 6, 6, nc)),
            "target_masks": (rng.random((t, 6, 6)) > 0.5)}


def head_losses(case, rows=slice(None), group=None):
    """The three head losses on `rows` (their means over the ranks of
    `group`) and their gradients in the predictions."""
    f = lambda k: torch.tensor(case[k][rows], dtype=torch.float32)  # noqa
    preds = {k: f(k).requires_grad_(True)
             for k in ("logits", "pred_deltas", "pred_masks")}
    ids = torch.tensor(case["class_ids"][rows])
    losses = torch.stack([
        L.mrcnn_class_loss(preds["logits"], ids,
                           torch.tensor(case["valid"][rows]), group),
        L.mrcnn_bbox_loss(preds["pred_deltas"], f("target_deltas"), ids,
                          group),
        L.mrcnn_mask_loss(preds["pred_masks"], f("target_masks"), ids,
                          group)])
    grads = torch.autograd.grad(losses.sum(), list(preds.values()))
    return losses.detach(), grads


def bn_step_draws(cfg, b):
    """The uniforms the JAX package's `compute_losses` draws from
    `PRNGKey(JAX_KEY)` for a batch of `b` (`train_batch`'s 4 GT boxes)."""
    import jax
    from tests.test_torch_train import jax_draws
    return jax_draws(jax.random.PRNGKey(JAX_KEY), b,
                     generate_anchors(cfg).shape[0], cfg.max_proposals + 4)


def _rank(rank, world, store, out_dir, draws):
    """One gloo rank: the BN layer and the head losses over the world's
    ranks on this rank's rows, then 2 frozen-BN DP training steps on this
    rank's image, then one batch-BN step with the global batch's `draws`."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        res = {}
        x, p, cot = bn_case()
        rows = slice(2 * rank, 2 * rank + 2)
        res["bn_naive"] = bn_grads(x[rows], p, cot[rows])
        res["bn"] = bn_grads(x[rows], p, cot[rows], dist.group.WORLD)
        case = head_loss_case()
        rows = slice(8 * rank, 8 * rank + 8)
        res["heads_naive"] = head_losses(case, rows)
        res["heads"] = head_losses(case, rows, dist.group.WORLD)

        cfg = tiny_test_config().replace(**TRAIN)
        state, opt = make_train_state(_params(cfg, seed=1), cfg)
        mesh.broadcast_state(state)
        step = mesh.data_parallel_train_step(cfg, opt)
        batch = train_batch(cfg, world)
        shard = {k: v[rank:rank + 1] for k, v in batch.items()}
        anchors = generate_anchors(cfg)
        metrics = []
        for _ in range(2):
            state, m = step(state, shard, anchors, seed=7)
            metrics.append({k: float(v) for k, v in m.items()})
        res["train"] = (state.params, state.momentum, state.step, metrics)

        cfg = tiny_test_config().replace(**BATCH_BN)
        state, opt = make_train_state(_params(cfg, seed=1), cfg)
        state, m = mesh.data_parallel_train_step(cfg, opt)(
            state, shard, anchors, draws=draws)
        res["train_batch_bn"] = (state.params, state.momentum,
                                 {k: float(v) for k, v in m.items()})
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """What each of the 2 ranks computed (`_rank`)."""
    out = tmp_path_factory.mktemp("ranks")
    draws = bn_step_draws(tiny_test_config(), WORLD)
    mp.spawn(_rank, args=(WORLD, str(out / "store"), str(out), draws),
             nprocs=WORLD, join=True)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def test_batch_bn_over_ranks_equals_global_batch(ranks):
    """Over the world's group each rank's BN output and input gradient
    equal one process's over the global batch on its rows, and the ranks'
    gamma and beta gradients add up to it (1e-6); without the group (each
    rank its own statistics) they do not."""
    y, gx, gg, gb = bn_grads(*bn_case())
    got = [r["bn"] for r in ranks]
    for name, want, idx in (("y", y, 0), ("dx", gx, 1)):
        np.testing.assert_allclose(torch.cat([g[idx] for g in got]).numpy(),
                                   want.numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=name)
    for want, idx in ((gg, 2), (gb, 3)):
        np.testing.assert_allclose(sum(g[idx] for g in got).numpy(),
                                   want.numpy(), rtol=1e-6, atol=1e-6)
    naive = torch.cat([r["bn_naive"][0] for r in ranks])
    assert float((naive - y).abs().max()) > 1e-2


def test_head_losses_normalize_over_the_global_batch(ranks):
    """3 positives on one rank and 1 on the other: over the world's group
    the ranks' head losses add up to the global batch's means and their
    gradients equal its, row by row; the mean of per-rank means (each
    rank on its own) is another loss."""
    case = head_loss_case()
    want, want_grads = head_losses(case)
    got = sum(r["heads"][0] for r in ranks)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
    for i in range(3):
        np.testing.assert_allclose(
            torch.cat([r["heads"][1][i] for r in ranks]).numpy(),
            want_grads[i].numpy(), rtol=1e-6, atol=1e-7)
    naive = sum(r["heads_naive"][0] for r in ranks) / WORLD
    assert ((naive - want).abs() > 1e-3 * want.abs()).all()


def test_dp_train_steps_match_single_process(ranks):
    """2 DP steps over 2 ranks, one image each, against 2 single-process
    steps on both images, with `tests/test_parallel.py`'s bounds for a
    mesh of more than one device (loss 2e-2 relative, params 1e-4,
    momentum 2e-2): every rank holds the same state."""
    cfg = tiny_test_config().replace(**TRAIN)
    state, opt = make_train_state(_params(cfg, seed=1), cfg)
    batch = train_batch(cfg, WORLD)
    anchors = generate_anchors(cfg)
    metrics = []
    for _ in range(2):
        state, m = train_step(state, batch, anchors, cfg, opt, seed=7)
        metrics.append({k: float(v) for k, v in m.items()})
    params, momentum, steps, dp_metrics = ranks[0]["train"]
    assert steps == state.step == 2
    for ms, md in zip(metrics, dp_metrics):
        assert set(ms) == set(md)
        for k in ms:
            np.testing.assert_allclose(md[k], ms[k], rtol=2e-2, atol=1e-6,
                                       err_msg=k)
    for tree, want, atol in ((params, state.params, 1e-4),
                             (momentum, state.momentum, 2e-2)):
        for layer, ws in want.items():
            for w, v in ws.items():
                np.testing.assert_allclose(tree[layer][w].numpy(),
                                           v.numpy(), rtol=1e-5, atol=atol,
                                           err_msg=f"{layer}/{w}")
    other = ranks[1]["train"]
    assert other[3] == dp_metrics
    for layer, ws in params.items():
        for w, v in ws.items():
            assert torch.equal(other[0][layer][w], v), (layer, w)


def test_dryrun_step_runs(capfd):
    mesh.dryrun_step(2, device="cpu")
    out = capfd.readouterr().out
    assert "DP-vs-single parity" in out and "over 2 cpu ranks" in out


def test_dryrun_step_asks_for_cards():
    """By default the ranks run on cards: with fewer than asked it raises
    before it spawns any."""
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"have {have}"):
        mesh.dryrun_step(have + 1)


def test_dp_batch_bn_step_matches_single_process_and_jax(ranks):
    """One batch-BN step (the default `train_bn`: statistics over both
    ranks' images in every backbone and head BN, and the head losses'
    shares) over 2 ranks, the sampling fed the JAX package's draws, against
    the port's single-process step and the JAX `train_step` on the global
    batch. `tests/test_parallel.py`'s bounds for more than one device
    (loss 2e-2 relative, params 1e-4) let the mean of per-rank loss means
    pass here (its losses 2.7e-3 relative and its params 7.7e-6 from the
    single process), so the losses are held at 1e-4 relative, as in
    `test_torch_train.py::test_compute_losses_match_jax`, and the params at
    1e-4 from JAX and 1e-6 from the single process, which differs from the
    DP step only in the order of the BN statistics' sums (the two stood
    9.5e-7 / 1.5e-6 and 1.8e-6 / 1.5e-8 apart when this was written).
    Local BN statistics on each rank miss both bounds by far (loss 3e-2,
    params 1.4e-4)."""
    import jax
    import jax.numpy as jnp
    from maskrcnn_tpu.core.config import tiny_test_config as jax_tiny
    from maskrcnn_tpu.train import step as jax_step

    cfg = tiny_test_config().replace(**BATCH_BN)
    params = _params(cfg, seed=1)
    batch = train_batch(cfg, WORLD)
    anchors = generate_anchors(cfg)
    state, opt = make_train_state(params, cfg)
    single, sm = train_step(state, batch, anchors, cfg, opt,
                            draws={k: torch.from_numpy(v) for k, v in
                                   bn_step_draws(cfg, WORLD).items()})
    jcfg = jax_tiny().replace(**BATCH_BN)
    jstate, tx = jax_step.make_train_state(
        {k: {w: jnp.asarray(v.numpy()) for w, v in ws.items()}
         for k, ws in params.items()}, jcfg)
    jnew, jm = jax_step.train_step(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.asarray(anchors), jax.random.PRNGKey(JAX_KEY), jcfg, tx)

    dp_params, dp_momentum, dp_metrics = ranks[0]["train_batch_bn"]
    assert ranks[1]["train_batch_bn"][2] == dp_metrics
    for name, metrics, tree, atol in (
            ("single", sm, single.params, 1e-6),
            ("jax", jm, jax.tree_util.tree_map(np.asarray, jnew.params),
             1e-4)):
        assert set(metrics) == set(dp_metrics)
        for k, v in metrics.items():
            np.testing.assert_allclose(dp_metrics[k], float(v), rtol=1e-4,
                                       err_msg=f"{name}: {k}")
        for layer, ws in tree.items():
            for w, v in ws.items():
                np.testing.assert_allclose(
                    dp_params[layer][w].numpy(), np.asarray(v), rtol=1e-5,
                    atol=atol, err_msg=f"{name}: {layer}/{w}")
    for layer, ws in single.momentum.items():
        for w, v in ws.items():
            np.testing.assert_allclose(dp_momentum[layer][w].numpy(),
                                       v.numpy(), rtol=1e-5, atol=2e-2,
                                       err_msg=f"{layer}/{w}")
