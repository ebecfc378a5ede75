"""The port's training input and output on the CPU: train-state
checkpoints (save / restore / resume, the background manager, metrics
log), the COCO train loader against the JAX package's (its native image
library switched off, as the port follows the PIL path), and `cli train`
on synthetic data and on a COCO workspace (`--device cpu`)."""

import json
import os
import shutil

import numpy as np
import jax  # noqa: F401  (the port's tests import both frameworks)
import pytest
import torch
from PIL import Image

import maskrcnn_tpu.evalkit.mask_rle as jax_rle
import maskrcnn_tpu.native
import maskrcnn_tpu.pipeline.loader as jax_loader
import maskrcnn_tpu_torch.evalkit.mask_rle as pt_rle
import maskrcnn_tpu_torch.native
import maskrcnn_tpu_torch.pipeline.loader as pt_loader
from maskrcnn_tpu.core.config import tiny_test_config as jax_tiny
from maskrcnn_tpu.train import data as jax_data
from maskrcnn_tpu_torch.cli.main import main
from maskrcnn_tpu_torch.core.anchors import generate_anchors
from maskrcnn_tpu_torch.core.config import tiny_test_config as pt_tiny
from maskrcnn_tpu_torch.io.weights import load_npz_checkpoint
from maskrcnn_tpu_torch.models.mask_rcnn import init_mask_rcnn
from maskrcnn_tpu_torch.train import data as pt_data
from maskrcnn_tpu_torch.train.checkpoint import (CheckpointManager,
                                                 MetricsLogger,
                                                 restore_train_state,
                                                 save_train_state)
from maskrcnn_tpu_torch.train.step import make_train_state, train_step
from tests.torch_support import train_batch
from tests.torch_support import one_thread  # noqa: F401  (autouse)

CFG = pt_tiny().replace(compute_dtype="float32")


@pytest.fixture(autouse=True)
def no_native(monkeypatch):
    """Both packages' PIL and numpy paths: their C++ libraries off."""
    monkeypatch.setattr(jax_loader, "get_imageio_lib", lambda: None)
    monkeypatch.setattr(maskrcnn_tpu.native, "get_imageio_lib", lambda: None)
    monkeypatch.setattr(jax_rle, "get_rle_lib", lambda: None)
    monkeypatch.setattr(pt_loader, "get_imageio_lib", lambda: None)
    monkeypatch.setattr(maskrcnn_tpu_torch.native, "get_imageio_lib",
                        lambda: None)
    monkeypatch.setattr(pt_rle, "get_rle_lib", lambda: None)


def _state(seed=0, cfg=CFG):
    params = init_mask_rcnn(torch.Generator().manual_seed(seed), cfg)
    return make_train_state(params, cfg)


def _assert_states_equal(a, b):
    assert a.step == b.step
    for tree_a, tree_b in ((a.params, b.params), (a.momentum, b.momentum)):
        assert set(tree_a) == set(tree_b)
        for layer, ws in tree_a.items():
            for w, v in ws.items():
                assert torch.equal(v, tree_b[layer][w]), (layer, w)


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

@pytest.mark.parametrize("momentum", ["float32", "bfloat16"])
def test_save_restore_and_resume_equal_uninterrupted(tmp_path, momentum):
    """2 steps + save + restore into a fresh template + 1 step equals 3
    steps in one go, bit for bit (the sampling draws depend on (seed,
    step) only)."""
    cfg = CFG.replace(train_momentum_dtype=momentum)
    anchors = generate_anchors(cfg)
    batch = train_batch(CFG, 1)
    state, opt = _state(cfg=cfg)
    for _ in range(2):
        state, _ = train_step(state, batch, anchors, cfg, opt, seed=9)
    path = str(tmp_path / "train_state.pt")
    save_train_state(state, path)
    assert not os.path.exists(path + ".tmp")

    fresh, opt2 = _state(seed=1, cfg=cfg)
    restored = restore_train_state(fresh, path)
    _assert_states_equal(restored, state)
    s1, m1 = train_step(state, batch, anchors, cfg, opt, seed=9)
    s2, m2 = train_step(restored, batch, anchors, cfg, opt2, seed=9)
    assert float(m1["loss"]) == float(m2["loss"])
    _assert_states_equal(s1, s2)
    assert s2.step == 3


def test_restore_refuses_another_structure(tmp_path):
    state, _ = _state()
    path = str(tmp_path / "s.pt")
    save_train_state(state, path)
    other, _ = _state(cfg=CFG.replace(num_classes=7))  # other head shapes
    with pytest.raises(ValueError, match="mrcnn_"):
        restore_train_state(other, path)
    bf16, _ = _state(cfg=CFG.replace(train_momentum_dtype="bfloat16"))
    with pytest.raises(ValueError, match="momentum"):
        restore_train_state(bf16, path)
    missing = state._replace(params={k: v for k, v in state.params.items()
                                     if k != "conv1"})
    with pytest.raises(ValueError, match="conv1"):
        restore_train_state(missing, path)
    torch.save({"weights": 1}, str(tmp_path / "junk.pt"))
    with pytest.raises(ValueError, match="not a train-state"):
        restore_train_state(state, str(tmp_path / "junk.pt"))


def test_checkpoint_manager_retention_and_resume(tmp_path):
    """Periodic saves prune to `keep`; restore_latest picks the newest."""
    state, _ = _state()
    mgr = CheckpointManager(str(tmp_path / "ckpts"), keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(state._replace(step=step))
    mgr.wait()
    names = sorted(os.listdir(tmp_path / "ckpts"))
    assert names == ["ckpt_00000003.pt", "ckpt_00000004.pt"]
    assert mgr.latest_step_path()[0] == 4
    fresh, _ = _state(seed=1)
    restored = mgr.restore_latest(fresh)
    assert restored.step == 4
    assert torch.equal(restored.params["conv1"]["kernel"],
                       state.params["conv1"]["kernel"])


def test_checkpoint_manager_empty_and_sync(tmp_path):
    state, _ = _state()
    mgr = CheckpointManager(str(tmp_path / "none"), keep=1)
    assert mgr.latest_step_path() is None
    assert mgr.restore_latest(state) is None
    sync = CheckpointManager(str(tmp_path / "sync"), keep=1,
                             background=False)
    assert os.path.exists(sync.save(state))  # landed before save returned


def test_checkpoint_write_failure_raises(tmp_path):
    state, _ = _state()
    mgr = CheckpointManager(str(tmp_path / "gone"))
    shutil.rmtree(tmp_path / "gone")  # the write will fail
    mgr.save(state)
    with pytest.raises(RuntimeError, match="checkpoint write"):
        mgr.wait()
    sync = CheckpointManager(str(tmp_path / "gone2"), background=False)
    shutil.rmtree(tmp_path / "gone2")
    with pytest.raises(RuntimeError, match="checkpoint write"):
        sync.save(state)


def test_metrics_logger(tmp_path):
    path = str(tmp_path / "m" / "metrics.jsonl")
    log = MetricsLogger(path)
    log.log(0, {"loss": torch.tensor(2.5)}, 1.0)
    log.log(5, {"loss": np.float32(1.25), "rpn_class_loss": 0.5}, 2.0)
    rows = [json.loads(line) for line in open(path)]
    assert [r["step"] for r in rows] == [0, 5]
    assert rows[0]["loss"] == 2.5
    assert rows[1]["loss"] == 1.25 and rows[1]["rpn_class_loss"] == 0.5
    MetricsLogger(None).log(0, {}, 0.0)  # disabled: no file, no error


# --------------------------------------------------------------------------
# the COCO train loader
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    """3 JPEGs (two sizes) with a square, a polygon and a crowd annotation
    (`tests/test_train_data.py`'s dataset, grown)."""
    td = tmp_path_factory.mktemp("traincoco")
    imgs = td / "imgs"
    os.makedirs(imgs)
    rng = np.random.default_rng(0)
    images, anns = [], []
    for i in range(3):
        h, w = (96, 128) if i < 2 else (140, 90)
        arr = rng.uniform(0, 255, (h, w, 3)).astype(np.uint8)
        fn = f"{i:06d}.jpg"
        Image.fromarray(arr).save(imgs / fn, quality=95)
        images.append({"id": i, "file_name": fn, "width": w, "height": h})
        anns.append({"id": 100 + i, "image_id": i, "category_id": 7,
                     "bbox": [20, 10, 30, 30], "area": 900, "iscrowd": 0,
                     "segmentation": [[20, 10, 50, 10, 50, 40, 20, 40]]})
        anns.append({"id": 200 + i, "image_id": i, "category_id": 11,
                     "bbox": [5, 40, 40, 35], "area": 700, "iscrowd": 0,
                     "segmentation": [[5, 40, 45, 50, 30, 75, 8, 60]]})
        if i == 1:
            anns.append({"id": 300, "image_id": i, "category_id": 9,
                         "bbox": [60, 50, 30, 20], "area": 600,
                         "iscrowd": 1,
                         "segmentation": [[60, 50, 90, 50, 90, 70, 60,
                                           70]]})
    inst = {"images": images, "annotations": anns,
            "categories": [{"id": 7, "name": "thing"},
                           {"id": 9, "name": "other"},
                           {"id": 11, "name": "misc"},
                           {"id": 13, "name": "x"}]}
    ann_path = td / "instances.json"
    with open(ann_path, "w") as f:
        json.dump(inst, f)
    return str(ann_path), str(imgs)


@pytest.mark.parametrize("kw", [
    dict(), dict(flip_prob=0.0), dict(flip_prob=1.0, max_instances=4),
    dict(image_dtype=np.float32, seed=3), dict(cache_images=8, seed=5)],
    ids=["default", "noflip", "allflip", "float32", "cached"])
def test_loader_batches_match_jax(coco_dir, kw):
    """Batches of steps 0-3 (images revisited, flips mixed) equal the JAX
    loader's: canvases, boxes, class ids (crowds negative) and
    mini-masks."""
    kw = dict(dict(batch_size=2, max_instances=8), **kw)
    want = jax_data.COCOTrainLoader(*coco_dir, jax_tiny(), **kw)
    got = pt_data.COCOTrainLoader(*coco_dir, pt_tiny(), **kw)
    classes = []
    for step in range(4):
        a, b = want.get_batch(step), got.get_batch(step)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        classes.append(b["gt_class_ids"])
    assert (np.stack(classes) < 0).any()     # the crowd came through


def test_loader_flip_and_crowd(coco_dir):
    loader = pt_data.COCOTrainLoader(*coco_dir, pt_tiny(), batch_size=1,
                                     max_instances=4)
    c0, b0, cl0, m0 = loader.load_example(1, flip=False)
    c1, b1, cl1, m1 = loader.load_example(1, flip=True)
    np.testing.assert_array_equal(c1, c0[:, ::-1])
    np.testing.assert_array_equal(cl1, cl0)
    assert (cl0 < 0).sum() == 1 and (cl0 > 0).sum() == 2  # one crowd
    np.testing.assert_array_equal(m1[0], m0[0][:, ::-1])
    np.testing.assert_allclose(b1[:3, [0, 2]], b0[:3, [0, 2]])
    np.testing.assert_allclose(b1[:3, 1], 1.0 - b0[:3, 3], atol=1e-6)
    np.testing.assert_array_equal(b1[3:], 0.0)
    assert m0[0].mean() > 0.9                      # the solid square


def test_loader_cache_prefetch_and_resume(coco_dir):
    """The cache changes nothing but the decode count (and hands out
    copies); the prefetcher returns the direct batches; a fresh loader
    asked for step 5 returns what one that walked steps 0-5 does."""
    plain = pt_data.COCOTrainLoader(*coco_dir, pt_tiny(), batch_size=2,
                                    seed=7)
    cached = pt_data.COCOTrainLoader(*coco_dir, pt_tiny(), batch_size=2,
                                     seed=7, cache_images=64)
    fetched = pt_data.PrefetchBatcher(pt_data.COCOTrainLoader(
        *coco_dir, pt_tiny(), batch_size=2, seed=7))
    try:
        for step in range(6):
            a, b, c = (plain.get_batch(step), cached.get_batch(step),
                       fetched.get_batch(step))
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
                np.testing.assert_array_equal(a[k], c[k])
    finally:
        fetched.close()
    fresh = pt_data.COCOTrainLoader(*coco_dir, pt_tiny(), batch_size=2,
                                    seed=7)
    for k, v in fresh.get_batch(5).items():
        np.testing.assert_array_equal(v, a[k])
    c1, b1, _, m1 = cached.load_example(cached.image_ids[0])
    c1[:] = 7
    b1[:] = -1
    c2, b2, _, _ = cached.load_example(cached.image_ids[0])
    assert (c2 != 7).any() and (b2 != -1).any()


def test_minimask_matches_jax(coco_dir):
    ann = {"bbox": [5, 40, 40, 35],
           "segmentation": [[5, 40, 45, 50, 30, 75, 8, 60]]}
    want = jax_data.minimask_from_annotation(ann, 96, 128, 28)
    got = pt_data.minimask_from_annotation(ann, 96, 128, 28)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1


# --------------------------------------------------------------------------
# cli train
# --------------------------------------------------------------------------

def test_cli_train_synthetic_state_output_and_resume(tmp_path, capsys,
                                                     monkeypatch):
    """`--synthetic --device cpu`: the state and a calibrated `.npz` are
    written; `--resume` continues to the total step with the losses an
    uninterrupted run logs; the metrics log gets a line per logged
    step."""
    monkeypatch.chdir(tmp_path)
    common = ["train", "t", "--synthetic", "--device", "cpu", "--batch",
              "1", "--log-every", "1", "--calibrate-batches", "1"]
    assert main(common + ["--steps", "3", "--state", "run.pt", "--output",
                          "out.npz", "--metrics-log", "m.jsonl"]) == 0
    out = capsys.readouterr().out
    assert "train state saved: run.pt (step 3)" in out
    assert "BN statistics calibrated over 1 batches" in out
    npz = load_npz_checkpoint("out.npz")
    state = torch.load("run.pt", weights_only=True)
    assert state["step"] == 3
    # calibration replaced the (0, 1) moving statistics
    assert np.abs(npz["bn_conv1"]["moving_mean"]).sum() > 0
    np.testing.assert_array_equal(
        npz["conv1"]["kernel"], state["params"]["conv1"]["kernel"].numpy())
    rows = [json.loads(x) for x in open("m.jsonl")]
    assert [r["step"] for r in rows] == [0, 1, 2]

    assert main(common + ["--steps", "5", "--state", "run.pt", "--resume",
                          "--no-calibrate"]) == 0
    out = capsys.readouterr().out
    assert "resumed from run.pt at step 3" in out
    assert "continuing to total step 5" in out
    assert "train state saved: run.pt (step 5)" in out
    resumed = [line for line in out.splitlines() if line.startswith("step")]

    assert main(common + ["--steps", "5", "--no-calibrate"]) == 0
    whole = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("step")]
    assert [r.split("(")[0] for r in resumed] == [
        r.split("(")[0] for r in whole[3:]]


def test_cli_train_checkpoint_dir_and_frozen(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["train", "t", "--synthetic", "--device", "cpu", "--batch", "1",
            "--steps", "2", "--train-bn", "frozen", "--bf16-momentum",
            "--remat", "--trainable", "heads", "--checkpoint-dir", "ck",
            "--checkpoint-every", "1", "--keep", "1", "--log-every", "5"]
    assert main(argv) == 0
    assert sorted(os.listdir("ck")) == ["ckpt_00000002.pt"]
    out = capsys.readouterr().out
    assert "calibrated" not in out           # frozen BN: nothing to redo
    assert main(argv[:8] + ["4", "--resume", "--checkpoint-dir", "ck",
                            "--train-bn", "frozen", "--bf16-momentum",
                            "--trainable", "heads"]) == 0
    assert "resumed from ck at step 2" in capsys.readouterr().out


def test_cli_train_on_coco(coco_dir, tmp_path, capsys, monkeypatch):
    """A COCO dataset through the prefetching loader, then calibration."""
    monkeypatch.chdir(tmp_path)
    cfg = tmp_path / "config.json"
    CFG.to_json(str(cfg))
    ann, imgs = coco_dir
    assert main(["train", "t", "--config", str(cfg), "--annotations", ann,
                 "--images_dir", imgs, "--steps", "2", "--batch", "2",
                 "--calibrate-batches", "1", "--cache-images", "4",
                 "--device", "cpu", "--output", "o.npz"]) == 0
    out = capsys.readouterr().out
    assert "step     1" in out and os.path.exists("o.npz")


def test_cli_train_needs_a_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["train", "t", "--synthetic", "--steps", "1"])
