"""`io/export.py` on the CPU: the detector forward as a `torch.export`
program over the kernels' custom ops, at `tiny_test_config()` in float32,
reloaded bit-equal to the eager forward (at batch 2, with on-device
paste), within the forward's tolerances of the JAX package's, and
loadable in a fresh process after `import maskrcnn_tpu_torch.ops`."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from maskrcnn_tpu.core.anchors import generate_anchors as jax_anchors
from maskrcnn_tpu.core.config import tiny_test_config as jax_tiny
from maskrcnn_tpu.models import mask_rcnn as jax_model
from maskrcnn_tpu_torch.core.config import MaskRCNNConfig
from maskrcnn_tpu_torch.core.config import tiny_test_config as pt_tiny
from maskrcnn_tpu_torch.io import export
from maskrcnn_tpu_torch.io.weights import params_from_numpy
from maskrcnn_tpu_torch.models import mask_rcnn as pt_model
from tests.test_torch_mobilenet import jit_live_bn_params
from tests.test_torch_model import OVERRIDES, TOL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, PASTE = 2, 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and these tests' many small ops slow by 10-20x when each one
    waits on threads the other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """(flat params, program dir, images, eager out, reloaded program's
    out) of one program at batch 2 with on-device paste."""
    flat = jit_live_bn_params(0, jax_tiny().replace(**OVERRIDES))
    cfg = pt_tiny().replace(**OVERRIDES)
    params = params_from_numpy(flat)
    out_dir = str(tmp_path_factory.mktemp("program"))
    path = export.export_program(params, cfg, out_dir, batch=BATCH,
                                 paste_size=PASTE, device="cpu")
    assert path == os.path.join(out_dir, "model.pt2")
    images = np.random.default_rng(1).uniform(
        0, 255, (BATCH, 128, 128, 3)).astype(np.float32)
    want = pt_model.forward(params, torch.from_numpy(images), cfg,
                            device="cpu", paste_size=PASTE)
    with torch.no_grad():
        got = export.load_program(out_dir)(torch.from_numpy(images))
    return flat, out_dir, images, want, got


def test_program_reloads_bit_equal(exported):
    _, out_dir, _, want, got = exported
    keys = ["detections", "masks", "valid", "pasted"]
    assert sorted(got) == sorted(keys)
    for k in keys:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
        assert torch.equal(got[k], want[k]), k
    assert got["pasted"].shape == (BATCH, 16, PASTE, PASTE)
    assert int(want["valid"].sum()) > 0
    assert MaskRCNNConfig.from_json(os.path.join(
        out_dir, "config.json")) == pt_tiny().replace(**OVERRIDES)


def test_verify_program_reports_zero(exported):
    flat, out_dir, *_ = exported
    cfg = pt_tiny().replace(**OVERRIDES)
    assert export.verify_program(out_dir, params_from_numpy(flat), cfg,
                                 batch=BATCH, seed=3, paste_size=PASTE,
                                 device="cpu") == 0.0


def test_program_within_forward_tolerance_of_jax(exported):
    """The reloaded program against the JAX `forward` on the same params
    and images: `valid` and the classes exact, boxes, scores and masks
    within `tests/test_torch_model.py`'s tolerances."""
    flat, _, images, _, got = exported
    jcfg = jax_tiny().replace(**OVERRIDES)
    jp = {k: {w: jnp.asarray(v) for w, v in d.items()}
          for k, d in flat.items()}
    want = jax_model.forward(jp, jnp.asarray(images),
                             jnp.asarray(jax_anchors(jcfg)), jcfg,
                             paste_size=PASTE)
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  np.asarray(want["valid"]))
    det = got["detections"].numpy()
    np.testing.assert_array_equal(det[..., 4],
                                  np.asarray(want["detections"])[..., 4])
    np.testing.assert_allclose(det, np.asarray(want["detections"]), **TOL)
    np.testing.assert_allclose(got["masks"].numpy(),
                               np.asarray(want["masks"]), **TOL)


def test_program_loads_in_a_fresh_process(exported):
    """In a new process the program does not load before `import
    maskrcnn_tpu_torch.ops` (its graph calls the kernels' ops by name),
    and after it gives the outputs of this process (one thread in both),
    with neither JAX nor the JAX package loaded."""
    _, out_dir, images, _, got = exported
    np.save(os.path.join(out_dir, "images.npy"), images)
    code = (
        "import sys, numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "d = sys.argv[1]\n"
        "try:\n"
        "    torch.export.load(d + '/model.pt2')\n"
        "    print('loaded without the ops')\n"
        "except RuntimeError:\n"
        "    print('refused')\n"
        "import maskrcnn_tpu_torch.ops\n"
        "m = torch.export.load(d + '/model.pt2').module()\n"
        "with torch.no_grad():\n"
        "    out = m(torch.from_numpy(np.load(d + '/images.npy')))\n"
        "np.savez(d + '/fresh.npz', **{k: v.numpy() for k, v in "
        "out.items()})\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'maskrcnn_tpu')))\n")
    run = subprocess.run([sys.executable, "-c", code, out_dir], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert run.stdout.split("\n")[:2] == ["refused", "[]"], run.stdout
    assert "torch.ops.maskrcnn_tpu_torch.nms_keep" in run.stderr
    with np.load(os.path.join(out_dir, "fresh.npz")) as fresh:
        assert sorted(fresh.files) == sorted(got)
        for k in fresh.files:
            np.testing.assert_array_equal(fresh[k], got[k].numpy())
