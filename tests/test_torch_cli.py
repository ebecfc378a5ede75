"""The port's CLI over a synthetic on-disk COCO workspace, on the CPU
(`--device cpu`, tiny config): convert (with `anchors.bin` bytes equal to
the JAX package's, and `--export-savedmodel`), evaluate (with `--dp` and
`--compare-tf`, the TF oracle), demo, stream, download; the `.h5` weight
bridge both ways against the JAX package's; and the bench script's parser
and its refusal to run without a card."""

import json
import os
import re
import sys

import h5py
import numpy as np
import jax  # noqa: F401  (the port's tests import both frameworks)
import pytest
import torch

import maskrcnn_tpu.evalkit.cocoeval as jax_ce
import maskrcnn_tpu.evalkit.mask_rle as jax_rle
import maskrcnn_tpu.native
import maskrcnn_tpu.pipeline.loader as jax_loader
import maskrcnn_tpu_torch.evalkit.cocoeval as pt_ce
import maskrcnn_tpu_torch.native
import maskrcnn_tpu_torch.pipeline.loader as pt_loader
from maskrcnn_tpu.core import anchors as jax_anchors
from maskrcnn_tpu.core.config import MaskRCNNConfig as JaxConfig
from maskrcnn_tpu.io import weights as jax_weights
from maskrcnn_tpu_torch.cli.main import main
from maskrcnn_tpu_torch.core.anchors import load_anchors_bin
from maskrcnn_tpu_torch.core.config import tiny_test_config as pt_tiny
from maskrcnn_tpu_torch.evalkit import mask_rle
from maskrcnn_tpu_torch.io import weights as pt_weights
from maskrcnn_tpu_torch.pipeline.detector import MaskRCNNDetector
from maskrcnn_tpu_torch.tools import bench
from tests.test_torch_serve import port_params

CONFIG = pt_tiny().replace(num_classes=2, compute_dtype="float32",
                           detection_score_threshold=0.0)
H, W = 120, 160


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A COCO dataset of 4 JPEGs with polygon annotations, a model
    workspace with `config.json` and Matterport-layout `weights.h5`, and a
    directory of 6 frames."""
    from PIL import Image
    root = tmp_path_factory.mktemp("cliws")
    os.makedirs(root / "data/coco/val2017")
    os.makedirs(root / "frames")
    rng = np.random.default_rng(3)
    images, annotations = [], []
    for img_id in (1, 2, 3, 4):
        arr = rng.integers(0, 60, (H, W, 3), dtype=np.uint8)
        x, y, w, h = 20 + 5 * img_id, 25, 40, 50
        arr[y:y + h, x:x + w] = [220, 40, 40]
        Image.fromarray(arr).save(
            root / f"data/coco/val2017/{img_id:012d}.jpg")
        images.append({"id": img_id, "width": W, "height": H,
                       "file_name": f"{img_id:012d}.jpg"})
        annotations.append({
            "id": img_id, "image_id": img_id, "category_id": 3,
            "bbox": [x, y, w, h], "area": w * h, "iscrowd": 0,
            "segmentation": [[x, y, x + w, y, x + w, y + h, x, y + h]]})
    for i in range(6):
        Image.fromarray(np.roll(arr, 9 * i, axis=1)).save(
            root / f"frames/{i:03d}.jpg")
    with open(root / "data/coco/instances_val2017.json", "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": 3, "name": "redbox"}]}, f)
    ws = root / ".maskrcnn/models/t"
    os.makedirs(ws)
    CONFIG.to_json(str(ws / "config.json"))
    pt_weights.save_h5_weights(port_params(CONFIG, 2), str(ws / "weights.h5"))
    return root


@pytest.fixture
def ws(workspace, monkeypatch):
    monkeypatch.chdir(workspace)
    monkeypatch.delenv("MASKRCNN_HOME", raising=False)
    return workspace


def test_convert_writes_products_equal_to_jax(ws, capsys):
    assert main(["convert", "t"]) == 0
    prod = ws / ".maskrcnn/models/t/products"
    jcfg = JaxConfig.from_json(str(prod / "config.json"))
    ref = str(ws / "anchors_jax.bin")
    jax_anchors.save_anchors_bin(jax_anchors.generate_anchors(jcfg), ref)
    got = (prod / "anchors.bin").read_bytes()
    assert got == open(ref, "rb").read()
    assert load_anchors_bin(str(prod / "anchors.bin"),
                            expect_count=CONFIG.num_anchors).shape == (
        CONFIG.num_anchors, 4)
    ckpt = pt_weights.load_npz_checkpoint(str(prod / "checkpoint.npz"))
    h5 = jax_weights.load_h5_weights(str(ws / ".maskrcnn/models/t/"
                                         "weights.h5"))
    assert set(ckpt) == set(h5)
    for layer in h5:
        for w, v in h5[layer].items():
            np.testing.assert_array_equal(ckpt[layer][w], v)
    assert "anchors.bin" in capsys.readouterr().out
    assert main(["convert", "t", "--fp16", "--output_dir", "p16"]) == 0
    with np.load(ws / "p16/checkpoint.npz") as z:
        assert all(z[k].dtype == np.float16 for k in z.files)


def test_evaluate_writes_results_and_both_tables(ws, capsys):
    rc = main(["evaluate", "t", "coco", "--limit", "4", "--batch", "2",
               "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    for t in ("bbox", "segm"):
        assert out.count(f"[{t}]") == 12, out
    with open(ws / ".maskrcnn/tmp/results.json") as f:
        rows = json.load(f)
    assert {r["image_id"] for r in rows} == {1, 2, 3, 4}
    assert len(rows) == 4 * CONFIG.max_detections
    for r in rows:
        assert r["category_id"] == 3
        assert r["segmentation"]["size"] == [H, W]
        m = mask_rle.decode(mask_rle.from_coco_segmentation(
            r["segmentation"], H, W))
        assert m.shape == (H, W)
    from maskrcnn_tpu_torch.evalkit.results import load_results_proto
    msg = load_results_proto(str(ws / ".maskrcnn/tmp/results.pb"))
    assert [int(res.imageInfo.id) for res in msg.results] == [1, 2, 3, 4]


def test_evaluate_uint8_and_exact(ws, capsys):
    assert main(["evaluate", "t", "coco", "--limit", "2", "--batch", "2",
                 "--uint8", "--results_dir", "u8", "--device", "cpu"]) == 0
    assert main(["evaluate", "t", "coco", "--limit", "1", "--exact",
                 "--results_dir", "exact", "--device", "cpu"]) == 0
    captured = capsys.readouterr()
    assert "--exact: float32 compute" in captured.err
    assert captured.out.count("AP @[0.50:0.95]") == 4
    with open(ws / "u8/results.json") as f:
        assert {r["image_id"] for r in json.load(f)} == {1, 2}


def test_demo_renders_image_size_png(ws, capsys):
    from PIL import Image
    rc = main(["demo", "t", "data/coco/val2017/000000000001.jpg",
               "-o", "out.png", "--device", "cpu"])
    assert rc == 0
    with Image.open(ws / "out.png") as im:
        assert im.size == (W, H)
    assert "rendered: out.png" in capsys.readouterr().out


def test_stream_frames_dir_and_synthetic(ws, capsys, monkeypatch):
    from maskrcnn_tpu_torch.pipeline import stream
    real = stream.run_stream
    probes = []

    def few_probes(*args, **kwargs):       # 40 blocking probes by default
        probes.append(kwargs.get("latency_probes"))
        return real(*args, **dict(kwargs, latency_probes=2))

    monkeypatch.setattr(stream, "run_stream", few_probes)
    rc = main(["stream", "t", "--frames-dir", "frames", "--micro-batch",
               "2", "--device-paste", "--json", "stream.json",
               "--device", "cpu"])
    assert rc == 0
    assert "6 frames" in capsys.readouterr().out
    with open(ws / "stream.json") as f:
        stats = json.load(f)
    assert stats["frames"] == 6 and stats["device"] == "cpu"
    assert stats["device_paste"] is True and stats["latency_probes"] == 2
    assert main(["stream", "t", "--num-frames", "3", "--micro-batch", "2",
                 "--device-frames", "--device", "cpu"]) == 0
    assert "3 frames" in capsys.readouterr().out
    assert probes == [None, None]


def test_entry_points_need_a_card_unless_asked(ws, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["demo", "t", "data/coco/val2017/000000000001.jpg"])


def test_evaluate_compare_tf_scores_the_oracle(ws, capsys):
    """`--compare-tf` runs the same weights through the TF oracle over the
    evaluated images: `results_tf.json` beside `results.json`, over the
    same image ids, and a second pair of AP tables headed (TF oracle)."""
    pytest.importorskip("tensorflow")
    assert main(["evaluate", "t", "coco", "--limit", "2", "--device", "cpu",
                 "--results_dir", "tfres", "--compare-tf"]) == 0
    out = capsys.readouterr().out
    assert "== bbox (TF oracle) ==" in out and "== segm (TF oracle) ==" in out
    assert len(re.findall(r"\[segm\] AP @\[0.50:0.95\]", out)) == 2
    rows = json.load(open(ws / "tfres" / "results.json"))
    tf_rows = json.load(open(ws / "tfres" / "results_tf.json"))
    assert {r["image_id"] for r in tf_rows} == {r["image_id"] for r in rows} \
        == {1, 2}
    assert all(r["segmentation"]["size"] == [H, W] for r in tf_rows)


def test_evaluate_compare_tf_without_tensorflow_exits_2(ws, capsys,
                                                        monkeypatch):
    """No silent fallback: where TensorFlow does not import, the command
    exits 2 naming it, before it evaluates anything."""
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    assert main(["evaluate", "t", "coco", "--device", "cpu",
                 "--results_dir", "notf", "--compare-tf"]) == 2
    assert "TensorFlow" in capsys.readouterr().err
    assert not os.path.exists(ws / "notf")


def test_evaluate_dp_writes_the_same_results(ws, capsys):
    """`--dp 2` on the CPU (the CPU listed twice) splits each batch of 3
    over two devices, padded to 4 (two images each), and writes the
    results.json of the single-device run at batch 2: the same shapes
    reach each conv, so the same numbers come out."""
    args = ["evaluate", "t", "coco", "--limit", "4", "--device", "cpu"]
    assert main(args + ["--batch", "2", "--results_dir", "one"]) == 0
    assert main(args + ["--batch", "3", "--results_dir", "dp",
                        "--dp", "2"]) == 0
    assert "data parallel over 2 devices" in capsys.readouterr().err
    rows = [json.load(open(ws / d / "results.json")) for d in ("one", "dp")]
    assert len(rows[0]) == 4 * CONFIG.max_detections
    assert rows[0] == rows[1]


def test_convert_exports_a_program_that_reloads_equal(ws, capsys):
    assert main(["convert", "t", "--output_dir", "pe", "--device", "cpu",
                 "--export-savedmodel", "prog", "--export-batch", "2"]) == 0
    out = capsys.readouterr().out
    assert "reload-vs-eager max |diff| 0.00e+00" in out, out
    assert os.path.getsize(ws / "prog/model.pt2") > 0
    with open(ws / "prog/config.json") as f:
        assert json.load(f)["num_classes"] == CONFIG.num_classes


@pytest.mark.parametrize("strict", [False, True])
def test_strict_export_fails_on_a_reload_mismatch(ws, capsys, monkeypatch,
                                                  strict):
    """A reload diff over 1e-4 warns, and with --strict-export exits 1."""
    import maskrcnn_tpu_torch.io.export as export
    monkeypatch.setattr(export, "export_program", lambda *a, **k: None)
    monkeypatch.setattr(export, "verify_program", lambda *a, **k: 2e-4)
    argv = ["convert", "t", "--output_dir", "pm", "--device", "cpu",
            "--export-savedmodel", "progm"]
    assert main(argv + ["--strict-export"] * strict) == (1 if strict else 0)
    err = capsys.readouterr().err
    assert "differs from the eager forward beyond 1e-4" in err
    assert ("--strict-export: failing" in err) == strict


def test_download_fails_cleanly_and_copies_a_local_mirror(ws, capsys):
    # a closed port on this host: refused at once, no outside traffic
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    rc = main(["download", "probe", "--timeout", "3",
               "--url", f"http://127.0.0.1:{port}/weights.h5"])
    assert rc == 1
    assert "download failed" in capsys.readouterr().err
    src = ws / "mirror_weights.h5"
    src.write_bytes(b"h5-bytes")
    assert main(["download", "mirrored", "--url", str(src)]) == 0
    out = ws / ".maskrcnn/models/mirrored/weights.h5"
    assert out.read_bytes() == b"h5-bytes"
    assert "copied local artifact" in capsys.readouterr().out


def _flat(seed=1):
    return pt_weights.params_to_numpy(port_params(CONFIG, seed))


def _assert_same(a, b):
    assert set(a) == set(b)
    for layer in a:
        assert set(a[layer]) == set(b[layer]), layer
        for w in a[layer]:
            np.testing.assert_array_equal(a[layer][w], b[layer][w])


@pytest.mark.parametrize("nest_rpn", [True, False])
def test_h5_written_by_jax_loads_in_port_and_back(tmp_path, nest_rpn):
    flat = _flat()
    jax_path, pt_path = str(tmp_path / "j.h5"), str(tmp_path / "p.h5")
    jax_weights.save_h5_weights(flat, jax_path, nest_rpn=nest_rpn)
    _assert_same(pt_weights.load_h5_weights(jax_path), flat)
    pt_weights.save_h5_weights(port_params(CONFIG, 1), pt_path,
                               nest_rpn=nest_rpn)
    _assert_same(jax_weights.load_h5_weights(pt_path), flat)
    with h5py.File(pt_path, "r") as f:
        assert ("rpn_model" in f) == nest_rpn
        k = f["mrcnn_mask_deconv/mrcnn_mask_deconv/kernel:0"][()]
        np.testing.assert_array_equal(
            k, flat["mrcnn_mask_deconv"]["kernel"].transpose(0, 1, 3, 2))
        assert list(f.attrs["layer_names"]) == list(
            h5py.File(jax_path, "r").attrs["layer_names"])
    params = pt_weights.load_mask_rcnn_weights(port_params(CONFIG, 9),
                                               jax_path)
    _assert_same(pt_weights.params_to_numpy(params), flat)


def test_from_checkpoint_reads_h5(tmp_path):
    path = str(tmp_path / "x.h5")
    flat = _flat(4)
    jax_weights.save_h5_weights(flat, path)
    det = MaskRCNNDetector.from_checkpoint(CONFIG, path, device="cpu")
    _assert_same(pt_weights.params_to_numpy(det.params), flat)


def test_h5_without_h5py_raises_a_clear_error(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="needs the h5py package"):
        pt_weights.load_h5_weights(str(tmp_path / "x.h5"))
    with pytest.raises(ImportError, match="convert"):
        pt_weights.save_h5_weights(_flat(), str(tmp_path / "x.h5"))


def test_bench_parser_and_no_card(capsys):
    args = bench.build_parser().parse_args([])
    assert (args.preset, args.batch, args.iters, args.warmup, args.arch,
            args.fuse) == ("full", 2, 10, 3, "resnet101", "config")
    args = bench.build_parser().parse_args(
        ["--preset", "tiny", "--fuse", "both", "--arch", "resnet50"])
    assert (args.preset, args.fuse, args.arch) == ("tiny", "both",
                                                   "resnet50")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card path is not taken")
    assert bench.main(["--preset", "tiny"]) != 0
    captured = capsys.readouterr()
    assert captured.out == "" and "no CUDA device" in captured.err


@pytest.mark.slow
def test_evaluate_matches_the_jax_cli(ws, capsys, monkeypatch):
    """The JAX CLI and the port's, same workspace and weights, float32:
    the same rows in results.json (boxes within 1e-3, scores within 1e-4)
    and the same masks on all but near-threshold pixels."""
    from maskrcnn_tpu.cli.main import main as jax_main
    monkeypatch.setattr(jax_loader, "get_imageio_lib", lambda: None)
    monkeypatch.setattr(maskrcnn_tpu.native, "get_imageio_lib", lambda: None)
    monkeypatch.setattr(jax_rle, "get_rle_lib", lambda: None)
    monkeypatch.setattr(jax_ce, "get_evalmatch_lib", lambda: None)
    monkeypatch.setattr(pt_loader, "get_imageio_lib", lambda: None)
    monkeypatch.setattr(maskrcnn_tpu_torch.native, "get_imageio_lib",
                        lambda: None)
    monkeypatch.setattr(mask_rle, "get_rle_lib", lambda: None)
    monkeypatch.setattr(pt_ce, "get_evalmatch_lib", lambda: None)
    args = ["evaluate", "t", "coco", "--limit", "4", "--batch", "2",
            "--weights", ".maskrcnn/models/t/weights.h5"]
    assert jax_main(args + ["--results_dir", "jx"]) == 0
    assert main(args + ["--results_dir", "pt", "--device", "cpu"]) == 0
    rows = [json.load(open(ws / d / "results.json")) for d in ("pt", "jx")]
    assert len(rows[0]) == len(rows[1]) > 0
    flipped = 0
    for a, b in zip(*rows):
        assert (a["image_id"], a["category_id"]) == (b["image_id"],
                                                    b["category_id"])
        np.testing.assert_allclose(a["bbox"], b["bbox"], atol=1e-3)
        assert abs(a["score"] - b["score"]) < 1e-4
        ma, mb = (mask_rle.decode(mask_rle.from_coco_segmentation(
            r["segmentation"], H, W)) for r in (a, b))
        flipped += int((ma != mb).sum())
    assert flipped <= 1e-4 * len(rows[0]) * H * W


def test_render_names_anchors_and_profiling_match_jax(tmp_path):
    """The small host modules the CLI uses, against the JAX package's:
    `render_detections` and `class_color`, `class_name`, `denorm_boxes`;
    and the port's `StageTimer`, `stage` and `trace`."""
    from maskrcnn_tpu.core import coco_names as jax_names
    from maskrcnn_tpu.pipeline.detector import Detection as JaxDetection
    from maskrcnn_tpu.utils import render as jax_render
    from maskrcnn_tpu_torch.core import coco_names as pt_names
    from maskrcnn_tpu_torch.core.anchors import denorm_boxes
    from maskrcnn_tpu_torch.pipeline.detector import Detection
    from maskrcnn_tpu_torch.utils import profiling
    from maskrcnn_tpu_torch.utils import render as pt_render
    rng = np.random.default_rng(12)
    img = rng.integers(0, 256, (60, 90, 3), dtype=np.uint8)
    mask = rng.uniform(size=(60, 90)) > 0.7

    def dets(cls):
        return [cls(box=(5.0, 8.5, 40.0, 70.0), class_id=17, score=0.875,
                    mask=mask),
                cls(box=(20.0, 1.0, 59.0, 30.0), class_id=3, score=0.5)]

    names = [pt_names.class_name(i) for i in range(81)]
    assert names == [jax_names.class_name(i) for i in range(81)]
    assert pt_names.class_name(3, 5) == jax_names.class_name(3, 5) == "3"
    np.testing.assert_array_equal(
        pt_render.render_detections(img, dets(Detection), class_names=names),
        jax_render.render_detections(img, dets(JaxDetection),
                                     class_names=names))
    assert [pt_render.class_color(i) for i in range(81)] == \
        [jax_render.class_color(i) for i in range(81)]
    boxes = rng.uniform(0, 1, (5, 4))
    np.testing.assert_array_equal(denorm_boxes(boxes, (128, 96)),
                                  jax_anchors.denorm_boxes(boxes, (128, 96)))

    timer = profiling.StageTimer()
    for _ in range(3):
        with timer.phase("decode"):
            pass
    assert timer.counts["decode"] == 3 and "avg over 3" in timer.report()
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.stage("paste"):
            torch.ones(4).sum()
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "paste" in f.read()


@pytest.mark.parametrize("exact", [False, True])
def test_serve_subcommand_serves_until_shutdown(ws, monkeypatch, exact):
    """`cli serve` warms up, serves on a port until shut down and stops its
    worker; its wire is uint8 unless --exact (`make_server`'s own default
    is float32)."""
    import inspect
    import threading
    import urllib.request
    from maskrcnn_tpu_torch.pipeline import serve
    assert inspect.signature(serve.make_server).parameters[
        "uint8_wire"].default is False
    made = []
    real = serve.make_server

    def capture(*args, **kwargs):
        made.append((kwargs["uint8_wire"],) + real(*args, **kwargs))
        return made[-1][1:]

    monkeypatch.setattr(serve, "make_server", capture)
    rc = []
    argv = ["serve", "t", "--port", "0", "--max-batch", "2", "--device",
            "cpu"] + (["--exact"] if exact else [])
    t = threading.Thread(target=lambda: rc.append(main(argv)), daemon=True)
    t.start()
    for _ in range(600):
        if made:
            break
        t.join(timeout=0.1)
    uint8_wire, server, worker = made[0]
    host, port = server.server_address[:2]
    with urllib.request.urlopen(f"http://{host}:{port}/healthz",
                                timeout=30) as r:
        assert json.loads(r.read())["max_batch"] == 2
    server.shutdown()
    t.join(timeout=30)
    assert not t.is_alive() and rc == [0]
    assert not worker.thread.is_alive()
    assert uint8_wire is (not exact)
