"""The port's host-side measurement tools (`maskrcnn_tpu_torch/tools/`:
`flagship_seed_band`, `bench_cocoeval`, `bench_results_leg`,
`serve_probe`) against the JAX package's (`tools/`) on the CPU: the same
band from the same reports, the same synthetic workloads and RLE strings
byte for byte, the same evaluator stats, the same report keys."""

import json
import os
import socket
import sys

import numpy as np
import jax  # noqa: F401  (the port's tests import both frameworks)
import pytest

import maskrcnn_tpu.evalkit.cocoeval as jax_ce
import maskrcnn_tpu.evalkit.mask_rle as jax_rle
import maskrcnn_tpu.native
import maskrcnn_tpu.utils.compile_cache
import maskrcnn_tpu_torch.evalkit.cocoeval as pt_ce
import maskrcnn_tpu_torch.evalkit.mask_rle as pt_rle
import maskrcnn_tpu_torch.native
from maskrcnn_tpu.evalkit.cocoeval import COCOEvaluator as JaxEvaluator
from maskrcnn_tpu_torch.evalkit.cocoeval import COCOEvaluator as PtEvaluator
from maskrcnn_tpu_torch.tools import bench_cocoeval as pt_bc
from maskrcnn_tpu_torch.tools import bench_results_leg as pt_rl
from maskrcnn_tpu_torch.tools import flagship_seed_band as pt_band
from maskrcnn_tpu_torch.tools import serve_probe as pt_sp
from tests.torch_support import one_thread  # noqa: F401  (autouse)
from tools import bench_cocoeval as jax_bc
from tools import bench_results_leg as jax_rl
from tools import flagship_seed_band as jax_band
from tools import serve_probe as jax_sp

TOOLS = os.path.join(os.path.dirname(__file__), os.pardir,
                     "maskrcnn_tpu_torch", "tools")
PROOFS = [os.path.join(TOOLS, f"flagship_proof_h100_seed{s}.json")
          for s in (0, 1)]
NUMERICS = [os.path.join(TOOLS, f"proof_numerics_h100_seed{s}.json")
            for s in (0, 1)]


def no_native(monkeypatch):
    """Both packages on their numpy/PIL fallbacks: the JAX package's
    native build may lose a race between test processes, and its
    fallback's paste differs from the native one by a few pixels."""
    monkeypatch.setattr(jax_rle, "get_rle_lib", lambda: None)
    monkeypatch.setattr(jax_ce, "get_evalmatch_lib", lambda: None)
    monkeypatch.setattr(maskrcnn_tpu.native, "get_imageio_lib", lambda: None)
    monkeypatch.setattr(pt_rle, "get_rle_lib", lambda: None)
    monkeypatch.setattr(pt_ce, "get_evalmatch_lib", lambda: None)
    monkeypatch.setattr(maskrcnn_tpu_torch.native, "get_imageio_lib",
                        lambda: None)


def run_jax(monkeypatch, main, argv):
    """A JAX tool's `main()`, which reads `sys.argv`."""
    monkeypatch.setattr(sys, "argv", ["tool"] + argv)
    return main()


# --- flagship_seed_band ------------------------------------------------------

def test_seed_band_equals_the_jax_tool(tmp_path, monkeypatch):
    """On the two committed proof reports the port's band file is the JAX
    tool's byte for byte; with `--numerics` it only adds that section."""
    jax_out, pt_out = tmp_path / "jax.json", tmp_path / "pt.json"
    run_jax(monkeypatch, jax_band.main,
            ["--inputs", *PROOFS, "--out", str(jax_out)])
    assert pt_band.main(["--inputs", *PROOFS, "--out", str(pt_out)]) == 0
    assert pt_out.read_bytes() == jax_out.read_bytes()
    jax_band_ = json.loads(jax_out.read_text())
    assert set(jax_band_["ap"]) == {f"{m}.{t}.{k}"
                                    for m in ("production", "exact_fp32")
                                    for t in ("bbox", "segm")
                                    for k in ("AP", "AP50", "AP75")}
    both = tmp_path / "both.json"
    assert pt_band.main(["--inputs", *PROOFS, "--numerics", *NUMERICS,
                         "--out", str(both)]) == 0
    got = json.loads(both.read_text())
    assert set(got) == set(jax_band_) | {"numerics"}
    assert {k: v for k, v in got.items() if k != "numerics"} == jax_band_


def test_numerics_band_reads_the_committed_reports(tmp_path):
    """The 64-image production and exact APs of the numerics reports are
    the proof reports' (training is bit-reproducible on the card); the
    320-image production - exact_fp32 bbox delta is -0.0080 / -0.0042
    (0.6886 - 0.6966 and 0.7035 - 0.7077, the committed `all_320` APs)."""
    out = tmp_path / "band.json"
    assert pt_band.main(["--inputs", *PROOFS, "--numerics", *NUMERICS,
                         "--out", str(out)]) == 0
    n = json.loads(out.read_text())["numerics"]
    assert n["seeds"] == [0, 1]
    # every variant at both seeds (seed 0's report was re-run with all six)
    assert n["variants"] == ["production", "production_layers",
                             "production_plain_k3k4", "bf16_table_anchors",
                             "exact_fp32", "exact_tf32"]
    proofs = [json.loads(open(p).read()) for p in PROOFS]
    for mode in ("production", "exact_fp32"):
        for t in ("bbox", "segm"):
            for met in ("AP", "AP50", "AP75"):
                assert n["ap"][f"{mode}.first_64.{t}.{met}"]["values"] == \
                    [p[mode][t][met] for p in proofs]
    delta = n["deltas_vs_exact_fp32"]["production.all_320.bbox.AP"]
    assert delta["values"] == [-0.008, -0.0042]
    assert delta["min"] == -0.008 and delta["max"] == -0.0042
    assert "exact_fp32" not in n["cross_mode"]
    assert n["cross_mode"]["production"]["n_matched"] == [1057, 1026]


def test_numerics_band_seed_from_the_report_else_the_name(tmp_path):
    with open(NUMERICS[1]) as f:
        report = json.load(f)
    keyed = tmp_path / "numerics_a.json"
    keyed.write_text(json.dumps(dict(report, seed=7)))
    named = tmp_path / "numerics_seed3.json"
    named.write_text(json.dumps(report))
    out = tmp_path / "band.json"
    assert pt_band.main(["--inputs", *PROOFS, "--numerics", str(keyed),
                         str(named), "--out", str(out)]) == 0
    assert json.loads(out.read_text())["numerics"]["seeds"] == [7, 3]
    nameless = tmp_path / "numerics.json"
    nameless.write_text(json.dumps(report))
    with pytest.raises(ValueError, match="no `seed`"):
        pt_band.main(["--inputs", *PROOFS, "--numerics", str(nameless),
                      "--out", str(out)])


def test_committed_three_seed_band_is_the_tools_output(tmp_path,
                                                      monkeypatch):
    """`flagship_band_h100_seeds012.json` is the tool's output over the
    committed reports (paths relative to the repo root, as it was made),
    and each seed's 320-image production - exact_fp32 AP lies within the
    0.02 target in bbox and segm."""
    monkeypatch.chdir(os.path.join(TOOLS, os.pardir, os.pardir))
    rel = "maskrcnn_tpu_torch/tools/"
    out = tmp_path / "band.json"
    assert pt_band.main(
        ["--inputs"] + [f"{rel}flagship_proof_h100_seed{s}.json"
                        for s in (0, 1)]
        + ["--numerics"] + [f"{rel}proof_numerics_h100_seed{s}.json"
                            for s in (0, 1, 2)]
        + ["--out", str(out)]) == 0
    committed = f"{rel}flagship_band_h100_seeds012.json"
    with open(committed, "rb") as f:
        assert out.read_bytes() == f.read()
    n = json.loads(out.read_text())["numerics"]
    assert n["seeds"] == [0, 1, 2]
    for t in ("bbox", "segm"):
        values = n["deltas_vs_exact_fp32"][f"production.all_320.{t}.AP"]
        assert len(values["values"]) == 3
        assert all(abs(v) <= 0.02 for v in values["values"])


# --- bench_cocoeval ----------------------------------------------------------

@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
def test_bench_cocoeval_synth_equals_the_jax_tool(iou_type, monkeypatch):
    """The synthetic workload at 20 images: the same annotations and
    results, RLE strings byte for byte."""
    for mod in (jax_bc, pt_bc):
        monkeypatch.setattr(mod, "COCODataset", lambda d: d)
    jax_ds, jax_res = jax_bc.synth(20, iou_type=iou_type)
    pt_ds, pt_res = pt_bc.synth(20, iou_type=iou_type)
    assert pt_ds == jax_ds and pt_res == jax_res
    segs = [a.get("segmentation") for a in pt_ds["annotations"] + pt_res]
    assert all(s is None for s in segs) == (iou_type == "bbox")
    for x, y, w, h in ((3.2, 4.9, 30.5, 12.1), (600.0, 470.0, 80.0, 40.0)):
        assert pt_bc.rect_rle(x, y, w, h, 480, 640).encode() == \
            jax_bc.rect_rle(x, y, w, h, 480, 640).encode()
        assert pt_bc.rect_pixel_area(x, y, w, h, 480, 640) == \
            jax_bc.rect_pixel_area(x, y, w, h, 480, 640)


def _stats(evaluator_cls, ds, results, iou_type):
    ev = evaluator_cls(ds, results, iou_type)
    ev.evaluate()
    ev.accumulate()
    return ev.summarize(verbose=False)


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
def test_bench_cocoeval_stats_equal_across_packages_and_matchers(
        iou_type, tmp_path, monkeypatch):
    """The evaluator's 12 stats on the 20-image workload: the port's native
    libraries against its numpy fallback, that against the JAX package's
    fallback; and the tool's `--json` reports (native and `--numpy`)."""
    pt_ds, pt_res = pt_bc.synth(20, iou_type=iou_type)
    native = _stats(PtEvaluator, pt_ds, pt_res, iou_type)
    reports = {}
    for flags in ([], ["--numpy"]):
        out = tmp_path / f"{len(flags)}.json"
        assert pt_bc.main(["--images", "20", "--iou-type", iou_type,
                           "--json", str(out)] + flags) == 0
        reports[tuple(flags)] = json.loads(out.read_text())
    # `--numpy` puts the native matcher back after its run
    assert pt_ce.get_evalmatch_lib is maskrcnn_tpu_torch.native \
        .get_evalmatch_lib
    no_native(monkeypatch)
    fallback = _stats(PtEvaluator, pt_ds, pt_res, iou_type)
    jax_ds, jax_res = jax_bc.synth(20, iou_type=iou_type)
    jax_stats = _stats(JaxEvaluator, jax_ds, jax_res, iou_type)
    assert native.tolist() == fallback.tolist() == jax_stats.tolist()
    assert 0 < native[0] < 1
    a, b = reports[()], reports[("--numpy",)]
    assert (a["matcher"], b["matcher"]) == ("native", "numpy")
    assert a["ap"] == b["ap"] == round(float(native[0]), 4)
    assert a["ar100"] == b["ar100"] == round(float(native[8]), 4)
    assert a["gts"] == len(pt_ds.anns) and a["dts"] == len(pt_res)


# --- bench_results_leg -------------------------------------------------------

@pytest.mark.parametrize("full_canvas", [False, True])
def test_bench_results_leg_rows_equal_the_jax_tool(full_canvas, tmp_path,
                                                   monkeypatch):
    """At 10 images x 5 detections: the COCO results rows the JAX tool
    scores (caught at its evaluator) equal the port's, RLE strings byte
    for byte; the port's two modes give the same rows; its `--json`
    report has the JAX tool's keys."""
    no_native(monkeypatch)
    caught = []

    def catch(ds, rows, iou_type):
        caught.append(rows)
        return JaxEvaluator(ds, rows, iou_type)

    monkeypatch.setattr(jax_rl, "COCOEvaluator", catch)
    run_jax(monkeypatch, jax_rl.main, ["--images", "10", "--dets", "5"]
            + (["--full-canvas"] if full_canvas else []))
    ds, raw = pt_rl.synth(10, 5)
    rows, _, _ = pt_rl.results_rows(ds, raw, full_canvas)
    assert len(rows) == 50 and rows == caught[0]
    assert all(isinstance(r["segmentation"]["counts"], str) for r in rows)
    other, _, _ = pt_rl.results_rows(ds, raw, not full_canvas)
    assert other == rows
    out = tmp_path / "leg.json"
    assert pt_rl.main(["--images", "10", "--dets", "5", "--json", str(out)]
                      + (["--full-canvas"] if full_canvas else [])) == 0
    report = json.loads(out.read_text())
    assert report["mode"] == ("full_canvas" if full_canvas else "region_rle")
    assert report["total_s"] >= 0
    jax_out = tmp_path / "jax_leg.json"
    run_jax(monkeypatch, jax_rl.main, ["--images", "10", "--dets", "5",
                                       "--json", str(jax_out)]
            + (["--full-canvas"] if full_canvas else []))
    assert set(report) == set(json.loads(jax_out.read_text()))


# --- serve_probe -------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_probe_report_has_the_jax_keys(tmp_path, monkeypatch):
    """`--tiny` at K = 1, 2 with 4 requests each: the port's report has
    the JAX tool's keys plus `warmup`, its points the JAX points' keys;
    every histogram accounts for its point's requests."""
    monkeypatch.setattr(maskrcnn_tpu.utils.compile_cache,
                        "enable_compilation_cache", lambda *a, **k: None)
    jax_out, pt_out = tmp_path / "jax.json", tmp_path / "pt.json"
    run_jax(monkeypatch, jax_sp.main,
            ["--tiny", "--port", str(free_port()), "--clients", "1", "2",
             "--requests", "4", "--out", str(jax_out)])
    assert pt_sp.main(["--tiny", "--device", "cpu", "--port", "0",
                       "--clients", "1", "2", "--requests", "4",
                       "--warmup-requests", "2", "--out", str(pt_out)]) == 0
    want, got = json.loads(jax_out.read_text()), json.loads(pt_out.read_text())
    assert set(got) == set(want) | {"warmup"}
    assert got["device"] == "cpu" and got["weights"] == "random"
    points = got["sweep"] + [got["warmup"]]
    assert all(set(p) == set(want["sweep"][0]) for p in points)
    assert [p["clients"] for p in got["sweep"]] == [1, 2]
    assert [p["requests"] for p in points] == [4, 4, 2]
    assert got["warmup"]["clients"] == 1
    for p in points + want["sweep"]:
        assert sum(int(n) * c for n, c in p["batch_size_hist"].items()) \
            == p["requests"]
        assert 0 < p["p50_latency_ms"] <= p["p95_latency_ms"] \
            <= p["p99_latency_ms"]
