"""Package hygiene of the PyTorch port, its CPU dispatch and its kernels'
launch plans. The kernels against their plain versions on the card are in
`tests/test_torch_gpu.py` (marked `gpu`), which two tests here hold to
importing neither JAX nor the JAX package."""

import os
import re
import subprocess
import sys

import numpy as np
import jax  # noqa: F401  (the port's tests import both frameworks)
import pytest
import torch

import maskrcnn_tpu_torch
from maskrcnn_tpu_torch.core.config import tiny_test_config
from maskrcnn_tpu_torch.models import heads as pt_heads
from maskrcnn_tpu_torch.models import mask_rcnn as pt_model
from maskrcnn_tpu_torch.ops import (bottleneck_cuda, cuda_lib, nms_cuda,
                                    roi_align, roi_align_cuda, stem_cuda)
from maskrcnn_tpu_torch.pipeline.detector import MaskRCNNDetector
from tests.test_torch_gpu import (_chain_case, _head_case, _roi_case,
                                  clustered_boxes, stem_params)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(maskrcnn_tpu_torch.__file__)


def _walk_package():
    """(dirpath, files) of the package's sources; `build/` holds what the
    kernel build writes, not sources."""
    for dirpath, dirnames, files in os.walk(PKG):
        dirnames[:] = [d for d in dirnames if d != "build"]
        yield dirpath, files


def _port_modules():
    mods = []
    for dirpath, files in _walk_package():
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                mods.append(rel[:-3].replace(os.sep, ".")
                            .removesuffix(".__init__"))
    return sorted(mods)


def test_import_loads_neither_jax_nor_the_jax_package():
    """Every module of the port, the CLI, evalkit and training included;
    `h5py` and `tensorflow` too stay unloaded (the `.h5` functions and the
    TF oracle import them, and the card's machine lacks them), and the
    repo's `tools/` (the port keeps its own copies)."""
    assert {f"maskrcnn_tpu_torch.train.{m}" for m in (
        "targets", "losses", "step", "calibrate", "checkpoint",
        "data")} <= set(_port_modules())
    assert {"maskrcnn_tpu_torch.models.mobilenet",
            "maskrcnn_tpu_torch.io.export",
            "maskrcnn_tpu_torch.parallel.mesh",
            "maskrcnn_tpu_torch.evalkit.tf_forward",
            "maskrcnn_tpu_torch.tools.flagship_proof"} <= set(_port_modules())
    code = ("import sys\n"
            f"for m in {_port_modules()!r}:\n"
            "    __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'maskrcnn_tpu', 'h5py', 'tensorflow', 'tools'))\n"
            "print(len(bad), bad[:5])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "0", out.stdout


def test_sources_name_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|maskrcnn_tpu|tools)\b", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, names in _walk_package():
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            src = f.read()
        assert not pat.search(src), path
        assert "__import__(\"jax" not in src, path


# Run first in a subprocess: jax and the JAX package then fail to import.
_BLOCK_JAX = (
    "import sys\n"
    "class _Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('jax', 'jaxlib', 'maskrcnn_tpu'):\n"
    "            raise ImportError('blocked: ' + name)\n"
    "sys.meta_path.insert(0, _Block())\n")


def test_gpu_test_file_imports_no_jax():
    code = (_BLOCK_JAX + "import tests.test_torch_gpu\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'maskrcnn_tpu'))\n"
            "print(len(bad), bad[:5])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "0", out.stdout


def test_kernel_bias_tool_and_its_tests_import_no_jax(monkeypatch):
    """The K3/K4 bias audit and its CPU tests load neither JAX nor the JAX
    package, and the tool needs a card unless asked for the CPU."""
    code = (_BLOCK_JAX + "import maskrcnn_tpu_torch.tools.kernel_bias\n"
            "import tests.test_torch_kernel_bias\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'maskrcnn_tpu', 'tools'))\n"
            "print(len(bad), bad[:5])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "0", out.stdout
    from maskrcnn_tpu_torch.tools import kernel_bias
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel_bias.main(["--root", os.path.join(ROOT, "no_such_root")])


def _ablations():
    from maskrcnn_tpu_torch.tools.probe_kernels import ABLATIONS
    return ABLATIONS


@pytest.mark.parametrize("name", sorted(_ablations()))
def test_probe_ablation_finds_its_source_text(name):
    """Each probe of `tools/probe_kernels.py` patches text that its
    kernel source still holds (on the card it raises otherwise, after the
    build of every probe before it)."""
    src, old, new = _ablations()[name]
    with open(os.path.join(ROOT, "maskrcnn_tpu_torch", "csrc", src)) as f:
        text = f.read()
    assert old in text and old != new


def test_gpu_tests_collect_and_skip_without_jax_or_conftest():
    """As on the card's machine (no JAX; tests/conftest.py imports it, so
    the run skips it): every `gpu` test is collected and runs to an end
    with no failure or error; without a card each skips with its reason."""
    code = (_BLOCK_JAX + "import pytest\n"
            "sys.exit(pytest.main(['--noconftest', '-m', 'gpu', '-q', '-rs',"
            " '-p', 'no:cacheprovider', 'tests/test_torch_gpu.py']))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    summary = out.stdout.strip().splitlines()[-1]
    assert "failed" not in summary and "error" not in summary, summary
    ran = sum(int(n) for n in re.findall(r"(\d+) (?:passed|skipped)",
                                         summary))
    assert ran > 0, summary
    if not torch.cuda.is_available():
        assert re.search(r"\d+ skipped", summary), summary
        assert "passed" not in summary, summary
        assert "needs an NVIDIA card" in out.stdout


def test_entry_points_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_test_config()
    params = pt_model.init_mask_rcnn(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MaskRCNNDetector(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_model.forward(params, np.zeros((1, 128, 128, 3), np.float32), cfg)
    assert MaskRCNNDetector(cfg, params, device="cpu").device.type == "cpu"
    from maskrcnn_tpu_torch.tools import serve_probe
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_probe.main(["--tiny", "--port", "0"])


def test_kernel_gates_stay_off_on_cpu():
    x = torch.zeros((1, 128, 128, 3))
    assert not stem_cuda.stem_supported(x, torch.bfloat16)
    blocks = [{"w1": torch.zeros(64, 64), "w3": torch.zeros(64, 256),
               "ws": torch.zeros(64, 256)}]
    assert not bottleneck_cuda.chain_supported(
        torch.zeros((1, 32, 32, 64)), torch.bfloat16, blocks)
    assert bottleneck_cuda.block_supported((1, 32, 32, 64), blocks[0])
    # the kernel masks ragged edge tiles itself; channel widths still gate
    assert bottleneck_cuda.block_supported((1, 30, 37, 64), blocks[0])
    assert not bottleneck_cuda.block_supported((1, 32, 32, 48), blocks[0])
    # the fused heads (K5, K6) take their plain versions on the CPU
    cfg = tiny_test_config().replace(fuse_classifier_head=True,
                                     fuse_mask_head=True,
                                     detection_score_threshold=0.0)
    params = pt_model.init_mask_rcnn(torch.Generator().manual_seed(0), cfg)
    cuda_lib.reset_launches()
    out = pt_model.forward(params, np.zeros((1, 128, 128, 3), np.float32),
                           cfg, device="cpu")
    assert out["masks"].shape == (1, cfg.max_detections, 28, 28)
    assert not any(cuda_lib.launches.values())


def test_fused_float32_config_raises_on_the_card():
    """A fused config in float32 is refused on a CUDA device before any
    work reaches it (the fused kernels take bf16), not run unfused."""
    cfg = tiny_test_config().replace(compute_dtype="float32",
                                     fuse_mask_head=True)
    params = pt_model.init_mask_rcnn(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="bfloat16 on the card"):
        pt_model.forward(params, np.zeros((1, 128, 128, 3), np.float32),
                         cfg, device="cuda")


def _nms_case(seed=0, b=2, n=600):
    rng = np.random.default_rng(seed)
    bx, vd = zip(*[clustered_boxes(rng, n) for _ in range(b)])
    return torch.from_numpy(np.stack(bx)), torch.from_numpy(np.stack(vd))


def test_wrappers_take_plain_version_on_cpu():
    cuda_lib.reset_launches()
    boxes, valid = _nms_case()
    keep = nms_cuda.nms_keep(boxes, valid, 0.7, 50)
    assert keep.dtype == torch.bool and keep.shape == valid.shape
    feats, ys, xs, level, valid_r, n = _roi_case()
    out = roi_align_cuda.roi_align(feats, ys, xs, level, valid_r, n)
    assert out.shape == (ys.shape[0], 7, 7, 32)
    rng = np.random.default_rng(0)
    sp = {k: {w: torch.from_numpy(v) for w, v in d.items()}
          for k, d in stem_params(rng).items()}
    y = stem_cuda.apply_stem(sp, torch.zeros((1, 64, 64, 3)))
    assert y.shape == (1, 16, 16, 64) and y.dtype == torch.bfloat16
    x, blocks = _chain_case()
    z = bottleneck_cuda.fused_bottleneck_chain(x, blocks)
    assert z.shape == (2, 32, 32, 256) and z.dtype == torch.bfloat16
    feats, prep, n, head, _ = _head_case(c=32, n=6)
    h = roi_align_cuda.roi_classifier_head(feats, *prep, n, head)
    assert h.shape == (12, roi_align_cuda.HEAD_OUT) and h.dtype == torch.float32
    feats, prep, n, mask, ids = _head_case(c=32, n=6, crop=14)
    mk = roi_align_cuda.roi_mask_head(feats, *prep, n, mask, ids)
    assert mk.shape == (12, 28, 28) and mk.dtype == torch.float32
    assert set(cuda_lib.launches) == {"nms", "roi_align", "stem",
                                      "bottleneck", "roi_classifier_head",
                                      "roi_mask_head"}
    assert not any(cuda_lib.launches.values())


@pytest.mark.parametrize("m", [2000, 74, 1, 300])
def test_classifier_head_plan_covers_output_once(m):
    """K5's dense-1 plan: the tiles cover the (M, 1024) output exactly once
    in each K group, the groups partition the 196 K chunks of 12544, and a
    block's shared memory fits the H100's 232,448 bytes."""
    k1, n1 = 49 * 256, 1024
    plan = roi_align_cuda.classifier_head_plan(m, k1, n1)
    gx, gy, split = plan["grid"]
    rows = plan["rows"]
    assert rows >= m > rows - roi_align_cuda.HEAD_BM
    cover = np.zeros((rows, n1), np.int32)
    for bx in range(gx):
        for by in range(gy):
            cover[bx * 128:(bx + 1) * 128, by * 256:(by + 1) * 256] += 1
    assert (cover == 1).all()
    chunks = [c for lo, hi in plan["groups"] for c in range(lo, hi)]
    assert chunks == list(range(k1 // 64)) and split == len(plan["groups"])
    assert all(hi > lo for lo, hi in plan["groups"])
    assert plan["smem_bytes"] <= roi_align_cuda.SMEM_PER_BLOCK
    assert gx * gy * split <= 132 or split == 1
    if m == 2000:
        assert (gx, gy, split) == (16, 4, 2)


@pytest.mark.parametrize("shape,mid,cout,proj,ok", [
    ((2, 256, 256, 64), 64, 256, True, True),     # res2a at 1024^2
    ((2, 128, 128, 512), 128, 512, False, True),  # res3 b-d
    ((2, 30, 37, 64), 64, 256, True, True),       # ragged edge tiles
    ((1, 1, 1, 256), 64, 256, False, True),       # one pixel
    ((2, 32, 32, 64), 96, 256, True, False),      # mid width 96
    ((2, 32, 32, 48), 64, 256, True, False),      # Cin not a multiple of 64
    ((2, 32, 32, 64), 64, 256, False, False),     # identity, Cin != Cout
])
def test_block_supported_takes_any_height_and_width(shape, mid, cout, proj,
                                                    ok):
    blk = {"w1": torch.zeros(shape[-1], mid), "w3": torch.zeros(mid, cout)}
    if proj:
        blk["ws"] = torch.zeros(shape[-1], cout)
    assert bottleneck_cuda.block_supported(shape, blk) == ok


def _op_cases():
    """(op name, wrapper call, plain call, op args) of each kernel's custom
    op at small shapes on the CPU."""
    boxes, valid = _nms_case()
    feats, ys, xs, level, valid_r, n = _roi_case()
    rng = np.random.default_rng(0)
    sp = {k: {w: torch.from_numpy(v) for w, v in d.items()}
          for k, d in stem_params(rng).items()}
    w, b = stem_cuda.fold_stem_weights(sp["conv1"], sp["bn_conv1"])
    images = torch.from_numpy(rng.uniform(-120, 130, (1, 64, 64, 3))
                              .astype(np.float32))
    x, blocks = _chain_case()
    hfeats, hprep, hn, head, _ = _head_case(c=32, n=6)
    mfeats, mprep, mn, mask, ids = _head_case(c=32, n=6, crop=14)
    rac = roi_align_cuda
    return {
        "nms_keep": (lambda: nms_cuda.nms_keep(boxes, valid, 0.7, 50),
                     lambda: nms_cuda.nms_keep_plain(boxes, valid, 0.7, 50),
                     (boxes, valid, 0.7, 50)),
        "roi_align": (
            lambda: rac.roi_align(feats, ys, xs, level, valid_r, n),
            lambda: rac.roi_align_plain(feats, ys, xs, level, valid_r, n),
            (feats, ys, xs, level, valid_r, n)),
        "roi_classifier_head": (
            lambda: rac.roi_classifier_head(hfeats, *hprep, hn, head),
            lambda: rac.classifier_head_plain(hfeats, *hprep, hn, head),
            (hfeats, *hprep, hn, [head[k] for k in rac.HEAD_KEYS])),
        "roi_mask_head": (
            lambda: rac.roi_mask_head(mfeats, *mprep, mn, mask, ids),
            lambda: rac.mask_head_plain(mfeats, *mprep, mn, mask, ids),
            (mfeats, *mprep, mn, [mask[k] for k in rac.MASK_KEYS], ids)),
        "stem": (lambda: stem_cuda.stem(images, w, b),
                 lambda: stem_cuda.stem_plain(images, w, b),
                 (images, w, b)),
        "bottleneck_chain": (
            lambda: bottleneck_cuda.fused_bottleneck_chain(x, blocks),
            lambda: bottleneck_cuda.chain_plain(x, blocks),
            (x, bottleneck_cuda._flatten_blocks(blocks))),
    }


OPS = ("nms_keep", "roi_align", "roi_classifier_head", "roi_mask_head",
       "stem", "bottleneck_chain")


@pytest.mark.parametrize("name", OPS)
def test_custom_op_passes_opcheck(name):
    """Each kernel is an op of the `maskrcnn_tpu_torch` namespace whose
    schema, fake (shape and dtype) implementation, autograd registration
    and dispatch `torch.library.opcheck` accepts."""
    args = _op_cases()[name][2]
    op = getattr(torch.ops.maskrcnn_tpu_torch, name).default
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("name", OPS)
def test_custom_op_equals_plain_version_on_cpu(name):
    """The wrapper (through the op) gives the plain version's output, bit
    for bit, and launches nothing."""
    call, plain, _ = _op_cases()[name]
    cuda_lib.reset_launches()
    got, want = call(), plain()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert not any(cuda_lib.launches.values())
