"""The port's flagship proof tool (`maskrcnn_tpu_torch/tools/flagship_proof.py`)
against the JAX package's (`tools/flagship_proof.py`) on the CPU: the same
synthetic dataset from a seed (annotation JSON, JPEG bytes, decoded
pixels), the same scores and cross-mode deltas on the same results files;
and a tiny CPU run of the whole tool (train, resume, both evaluate modes,
its report's keys), which needs a card unless asked for the CPU."""

import json
import os
import sys

import numpy as np
import jax  # noqa: F401  (the port's tests import both frameworks)
import pytest
import torch

from maskrcnn_tpu_torch.evalkit import mask_rle
from maskrcnn_tpu_torch.tools import flagship_proof as pt_fp
from tools import flagship_proof as jax_fp

# the keys of the JAX tool's report (`tools/flagship_proof.py::main`)
JAX_REPORT_KEYS = {"architecture", "image_size", "num_classes",
                   "train_images", "val_images", "steps", "batch", "seed",
                   "train_seconds", "production", "exact_fp32",
                   "ap_delta_production_vs_exact", "cross_mode_deltas"}


def tiny(steps=2):
    """The tool's tiny CPU flags."""
    return ["--tiny", "--arch", "resnet50", "--image-size", "128",
            "--steps", str(steps), "--batch", "1", "--train-images", "2",
            "--val-images", "1"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and these tests' many small ops slow by 10-50x when each one
    waits on threads the other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    roots = {}
    for name, mod in (("pt", pt_fp), ("jax", jax_fp)):
        root = str(tmp_path_factory.mktemp(f"ds_{name}"))
        mod.make_dataset(root, 4, 2, 256, seed=7)
        roots[name] = root
    return roots


@pytest.mark.parametrize("split", ["train", "val"])
def test_make_dataset_matches_jax(datasets, split):
    from PIL import Image

    def files(root):
        ann = os.path.join(root, "data/coco", f"instances_{split}2017.json")
        with open(ann) as f:
            return json.load(f)

    got, want = files(datasets["pt"]), files(datasets["jax"])
    assert got == want
    assert len(got["images"]) == (4 if split == "train" else 2)
    assert got["annotations"]
    for im in got["images"]:
        paths = [os.path.join(datasets[k], "data/coco", f"{split}2017",
                              im["file_name"]) for k in ("pt", "jax")]
        blobs = [open(p, "rb").read() for p in paths]
        assert blobs[0] == blobs[1], im["file_name"]
        pixels = [np.asarray(Image.open(p).convert("RGB")) for p in paths]
        assert pixels[0].shape == (256, 256, 3)
        np.testing.assert_array_equal(pixels[0], pixels[1])


def _results(root, jitter, seed):
    """COCO results rows over the val GT: each shape's box and polygon
    moved by up to `jitter` pixels, a random score, plus one false
    positive an image."""
    rng = np.random.default_rng(seed)
    with open(os.path.join(root, "data/coco/instances_val2017.json")) as f:
        val = json.load(f)
    size = {im["id"]: (im["height"], im["width"]) for im in val["images"]}
    rows = []
    for a in val["annotations"]:
        h, w = size[a["image_id"]]
        dx, dy = rng.uniform(-jitter, jitter, 2)
        poly = [v + (dx if i % 2 == 0 else dy)
                for i, v in enumerate(a["segmentation"][0])]
        rle = mask_rle.from_polygons([poly], h, w)
        x, y, bw, bh = a["bbox"]
        rows.append({"image_id": a["image_id"],
                     "category_id": a["category_id"],
                     "bbox": [x + dx, y + dy, bw, bh],
                     "score": float(rng.uniform(0.5, 1.0)),
                     "segmentation": {"size": [h, w],
                                      "counts": mask_rle.to_coco_counts(rle)}})
    for img_id, (h, w) in size.items():
        box = [10.0, 10.0, 40.0, 30.0]
        poly = [10, 10, 50, 10, 50, 40, 10, 40]
        rle = mask_rle.from_polygons([poly], h, w)
        rows.append({"image_id": img_id, "category_id": 1, "bbox": box,
                     "score": float(rng.uniform(0.0, 0.6)),
                     "segmentation": {"size": [h, w],
                                      "counts": mask_rle.to_coco_counts(rle)}})
    return rows


@pytest.fixture(scope="module")
def results_files(datasets, tmp_path_factory):
    d = tmp_path_factory.mktemp("results")
    paths = {}
    for mode, (jitter, seed) in {"production": (3.0, 1),
                                 "exact_fp32": (2.0, 2),
                                 "tf_oracle": (8.0, 3)}.items():
        paths[mode] = str(d / f"{mode}.json")
        with open(paths[mode], "w") as f:
            json.dump(_results(datasets["pt"], jitter, seed), f)
    return paths


@pytest.mark.parametrize("mode", ["production", "exact_fp32", "tf_oracle"])
def test_score_matches_jax(datasets, results_files, mode):
    got = pt_fp.score(datasets["pt"], results_files[mode], 2)
    want = jax_fp.score(datasets["jax"], results_files[mode], 2)
    assert got == want
    assert 0 < got["bbox"]["AP"] < 1 and 0 < got["segm"]["AP"] < 1


def test_cross_mode_deltas_matches_jax(datasets, results_files):
    got = pt_fp.cross_mode_deltas(datasets["pt"], results_files, 2)
    want = jax_fp.cross_mode_deltas(datasets["jax"], results_files, 2)
    assert got == want
    assert set(got) == {"production_vs_exact_fp32",
                        "production_vs_tf_oracle", "exact_fp32_vs_tf_oracle"}
    assert got["production_vs_exact_fp32"]["n_matched"] > 0


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """The tool at the tiny CPU flags: 2 steps from scratch."""
    root = tmp_path_factory.mktemp("proof")
    out = root / "report.json"
    rc = pt_fp.main(tiny() + ["--root", str(root), "--out", str(out),
                              "--device", "cpu"])
    assert rc == 0
    with open(out) as f:
        return root, json.load(f)


def test_tool_report_has_the_jax_keys(tiny_run):
    _, report = tiny_run
    assert JAX_REPORT_KEYS <= set(report)
    assert report["device"] == "cpu" and report["train_steps_run"] == 2
    for mode in ("production", "exact_fp32"):
        assert set(report[mode]) == {"bbox", "segm",
                                     "eval_seconds_incl_compile"}
        assert set(report[mode]["bbox"]) == {"AP", "AP50", "AP75", "AR100"}
    assert set(report["kernels"]) == {"train", "production", "exact_fp32"}
    # the CPU runs the plain versions: no kernel launches
    assert not any(n for k in report["kernels"].values() for n in k.values())
    assert [r["step"] for r in report["train_log"]] == [0, 1]
    assert all(np.isfinite(v) for r in report["train_log"]
               for v in r.values())


def test_tool_resumes_to_the_total_step(tiny_run):
    """`--steps` is the total under resume: a second call with 3 steps
    runs one more from the checkpoint of the first."""
    root, _ = tiny_run
    out = root / "report_resumed.json"
    assert pt_fp.main(tiny(3) + ["--root", str(root), "--out", str(out),
                                 "--device", "cpu"]) == 0
    with open(out) as f:
        report = json.load(f)
    assert report["steps"] == 3 and report["train_steps_run"] == 1
    assert [r["step"] for r in report["train_log"]] == [2]


def test_tool_tf_oracle_exits_2_without_tensorflow(tiny_run, monkeypatch,
                                                   capsys):
    root, _ = tiny_run
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    rc = pt_fp.main(tiny() + ["--root", str(root), "--skip-train",
                              "--tf-oracle", "--device", "cpu"])
    assert rc == 2
    assert "TensorFlow" in capsys.readouterr().err


def test_tool_needs_a_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_fp.main(tiny() + ["--root", str(tmp_path)])


def test_proof_numerics_scores_each_variant(tiny_run):
    """`tools/proof_numerics.py` over the tiny run's checkpoint: each of
    the six variants scored over the proof's first 64 val images and
    over every val image of the root (the one there is), with its deltas against exact float32; the
    kernel gates, the kernel entry points and the TF32 switches it sets
    come back as they were."""
    from maskrcnn_tpu_torch.ops import bottleneck_cuda, stem_cuda
    from maskrcnn_tpu_torch.tools import proof_numerics

    root, _ = tiny_run
    gates = (stem_cuda.stem_supported, bottleneck_cuda.chain_supported,
             stem_cuda.stem, bottleneck_cuda.fused_bottleneck_chain)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    out = root / "numerics.json"
    assert proof_numerics.main([
        "--root", str(root), "--out", str(out), "--device", "cpu"]) == 0
    assert (stem_cuda.stem_supported, bottleneck_cuda.chain_supported,
            stem_cuda.stem, bottleneck_cuda.fused_bottleneck_chain) == gates
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == tf32
    with open(out) as f:
        report = json.load(f)
    for name in proof_numerics.VARIANTS:
        assert set(report[name]) == {"first_64", "all_1", "launches",
                                     "peak_gb", "seconds"}
        assert report[name]["first_64"] == report[name]["all_1"]
        assert set(report[name]["all_1"]) == {"bbox", "segm"}
    assert set(report["deltas_vs_exact_fp32"]) == \
        set(proof_numerics.VARIANTS) - {"exact_fp32"}


def test_run_counted_turns_tf32_off_only_for_exact(monkeypatch):
    """`run_counted(exact=True)` runs the command with TF32 off in cuDNN
    and matmuls and puts the previous setting back; without `exact` the
    setting is left as it is."""
    seen = []

    def cli(argv):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return 0

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    cpu = torch.device("cpu")
    assert pt_fp.run_counted(cli, [], cpu, exact=True)[0] == 0
    assert pt_fp.run_counted(cli, [], cpu)[0] == 0
    assert seen == [(False, False), (True, True)]
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == (True, True)
