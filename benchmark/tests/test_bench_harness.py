"""The harness on the CPU: every file it finds by name loads, a cell can be
added by adding files, a tiny run of each cell comes out correct, and the
faults a run can have, and the float8 control, come out not correct.
Nothing here needs the card."""

from __future__ import annotations

import filecmp
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import faults, harness
from benchmark.reference import check

ROOT = harness.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]


def _run_module():
    spec = importlib.util.spec_from_file_location(
        "benchmark_run", os.path.join(harness.HERE, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tiny_cell(name: str):
    """The cell at a size the CPU runs in seconds: the tiny configuration
    with the cell's architecture, classes, anchor scales (so that
    neighbouring anchors overlap as at full size, and NMS has work) and
    head fusion, float32, threshold 0, the mix's batch, pool and paste cut
    to it."""
    from maskrcnn_tpu_torch.core.config import tiny_test_config
    cell = harness.load_cell(name)
    full = cell.model_config()
    cfg = tiny_test_config().replace(
        architecture="resnet50" if full.architecture.startswith("resnet")
        else full.architecture, num_classes=full.num_classes,
        anchor_scales=full.anchor_scales, compute_dtype="float32",
        detection_score_threshold=0.0,
        fuse_classifier_head=full.fuse_classifier_head,
        fuse_mask_head=full.fuse_mask_head)
    mix = dict(cell.mix, pool=4)
    if "batch" in mix:
        mix.update(batch=2, long_side=100)
    if "paste_size" in mix:
        mix.update(paste_size=cfg.image_height, sync_every=2)
    cell.mix = mix
    cell.check = dict(cell.check, sample_images=4)
    return cell, cfg


def tiny_run(name: str, seed: int = 2 ** 31 + 5):
    cell, cfg = tiny_cell(name)
    torch.set_num_threads(1)
    return _run_module().run_cell(cell, seed, 1.5, False, device="cpu",
                                  cfg=cfg)


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads(name):
    cell = harness.load_cell(name)
    cfg = cell.model_config()
    assert cfg.architecture == cell.config["config"]["architecture"]
    assert hasattr(harness.load_module("drivers", cell.mix["driver"]),
                   "Traffic")
    allowed = set(check.NUMBERS) | {k + "_far" for k in check.SHARES}
    assert set(cell.check["limits"]) <= allowed
    assert cell.end_to_end() and cell.per_layer()
    assert "setup_s" in {m["name"] for m in cell.end_to_end()}
    for m in cell.per_layer():
        assert callable(harness.load_module("metrics", m["name"]).read)
        assert m["moves"] in {e["name"] for e in cell.end_to_end()}


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_every_config_file(entry):
    from maskrcnn_tpu_torch.core.config import MaskRCNNConfig
    conf = json.load(open(os.path.join(ROOT, entry["file"])))
    fields = set(MaskRCNNConfig.__dataclass_fields__)
    assert set(conf["config"]) <= fields
    assert sorted(conf["reduced"]) == sorted(entry["reduced"])
    assert conf["source"] == entry["source"]
    MaskRCNNConfig.from_dict(conf["config"])


def test_a_cell_and_a_metric_are_added_by_files_only(tmp_path):
    """A copy with a new traffic mix, a new cell and a new per-layer
    metric, each a new file plus its BENCHMARK.json entry: the harness
    finds them by name and no file it already had changed."""
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({
        "name": "r101.batch2", "config": "r101_fpn_coco",
        "traffic": "batch2", "chips": 1, "why": "a smaller batch"})
    bench["per_layer"].append({
        "name": "images.traced", "unit": "images", "better": "higher",
        "source": "device_trace", "layer": "device",
        "moves": "images_per_s", "workloads": ["r101.batch2"]})
    for e in bench["end_to_end"]:
        if "workloads" in e and e["name"] == "images_per_s":
            e["workloads"].append("r101.batch2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    b = tmp_path / "benchmark"
    (b / "traffic" / "batch2.json").write_text(json.dumps(
        dict(json.load(open(b / "traffic" / "batch8.json")), batch=2)))
    (b / "workloads" / "r101.batch2.json").write_text(
        (b / "workloads" / "r101.batch8.json").read_text())
    (b / "metrics" / "images.traced.py").write_text(
        "def read(measured):\n    return measured.trace.images\n")
    probe = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from benchmark import harness\n"
        "c = harness.load_cell('r101.batch2')\n"
        "m = [x['name'] for x in c.per_layer()]\n"
        "r = harness.load_module('metrics', 'images.traced').read\n"
        "print(c.mix['batch'], c.mix['driver'], 'images.traced' in m,"
        " [x['name'] for x in c.end_to_end()])\n")
    out = subprocess.run([sys.executable, "-c", probe, str(tmp_path)],
                         capture_output=True, text=True, check=True)
    assert out.stdout.split()[:3] == ["2", "batch_closed", "True"]
    assert "images_per_s" in out.stdout
    cmp = filecmp.dircmp(harness.HERE, b, ignore=["__pycache__", ".cache"])
    assert not cmp.diff_files


@pytest.mark.parametrize("name", CELLS)
def test_tiny_run_is_correct(name):
    cell, _ = tiny_cell(name)
    res = tiny_run(name)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end()}
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(cell.check["limits"])


@pytest.mark.parametrize("kind", faults.KINDS)
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, kind):
    """Each fault of `faults.py` planted in the program: outputs left out
    or moved, K1 or the detection NMS suppressing nothing or too much, the
    second-best class kept."""
    cell, cfg = tiny_cell(name)
    with faults.planted(kind, cfg):
        res = tiny_run(name)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_float8_control_is_not_correct(name):
    """The reference one precision below bfloat16, in the program's place,
    fails one of the cell's limits (its chip readings: PERF.md)."""
    from benchmark import control
    cell, cfg = tiny_cell(name)
    ctx = harness.make_context(cell, 2 ** 31 + 9, "cpu", cfg)
    traffic = harness.make_traffic(ctx)
    images = torch.as_tensor(traffic.pool[:ctx.sample_images])
    traffic.release()
    got = control.control_outputs(ctx, images, 2,
                                  cell.mix.get("paste_size"))
    checks, ok = harness.judge(ctx, cell, images, got)
    assert not ok, checks


def test_forbidden_modules_compare_whole_names(monkeypatch):
    base = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "maskrcnn_tpu_torch.ops", object())
    monkeypatch.setitem(sys.modules, "jax_like", object())
    assert set(harness.forbidden_modules()) == base
    monkeypatch.setitem(sys.modules, "maskrcnn_tpu.core", object())
    monkeypatch.setitem(sys.modules, "jaxlib.xla", object())
    assert set(harness.forbidden_modules()) - base == {"maskrcnn_tpu",
                                                       "jaxlib"}


def test_a_run_loads_neither_jax_nor_the_jax_package():
    probe = ("import sys, runpy\n"
             "sys.argv = ['run.py']\n"
             "from benchmark.tests import test_bench_harness as t\n"
             "res = t.tiny_run('r101.batch8')\n"
             "from benchmark import harness\n"
             "print(res['correct'], harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.stdout.strip().splitlines()[-1] == "True []"


def test_without_the_program_a_run_fails_and_prints_nothing(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
