"""The K3/K4 bias audit (`maskrcnn_tpu_torch/tools/kernel_bias.py`) on the
CPU: the float64 plain versions against the float32 ones, the audit's
statistics and rule against stand-in kernels with a planted lean and one
that only reorders its float32 sums, and the tool end to end on a tiny
flagship-proof root.

This file imports neither JAX nor the JAX package. Inputs are made with
numpy from a seed; the sizes are `tiny_test_config()`'s (R50 @ 128^2:
the stem's 32^2 output, res2 at 32^2, res3 at 16^2), at full width."""

import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from maskrcnn_tpu_torch.core.config import tiny_test_config
from maskrcnn_tpu_torch.io.weights import params_from_numpy
from maskrcnn_tpu_torch.ops import bottleneck_cuda, stem_cuda
from maskrcnn_tpu_torch.tools import kernel_bias as kb
from tests.test_torch_gpu import stage_params, stem_params

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and these tests' many small ops slow by 10-50x when each one
    waits on threads the other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _size():
    return tiny_test_config().image_height


def stem_case(seed):
    """(images, folded w, bias) at the tiny config's input size."""
    rng = np.random.default_rng(seed)
    p = params_from_numpy(stem_params(rng))
    w, bias = stem_cuda.fold_stem_weights(p["conv1"], p["bn_conv1"])
    s = _size()
    images = torch.from_numpy(rng.uniform(-124, 132, (1, s, s, 3))
                              .astype(np.float32))
    return images, w, bias


# (stage, cin, mid, cout, projection, feature size / input size) of R50's
# K4 blocks: res2a projects, res2b-c and res3b-d do not
BLOCKS = {"res2a": (2, 64, 64, 256, True, 4),
          "res2b": (2, 256, 64, 256, False, 4),
          "res3b": (3, 512, 128, 512, False, 8)}


def block_case(name, seed):
    """(x bf16, folded block) of block `name` at the tiny config's size."""
    stage, cin, mid, cout, proj, stride = BLOCKS[name]
    rng = np.random.default_rng(seed)
    params = params_from_numpy(stage_params(rng, stage, cin, mid, cout, "a",
                                            proj))
    blk = bottleneck_cuda.fold_bottleneck_chain(params, stage, "a")[0]
    hw = _size() // stride
    x = torch.from_numpy(rng.standard_normal((1, hw, hw, cin))
                         .astype(np.float32)).to(torch.bfloat16)
    return x, blk


def one_ulp_apart(a, b, slack):
    """Elements where |a - b| is over one bf16 ulp at the larger of |a|,
    |b| plus `slack` x max|b| (a float32 sum's error next to 0)."""
    a, b = a.double(), b.double()
    allowed = kb.bf16_ulp(torch.maximum(a.abs(), b.abs()))
    return int(((a - b).abs() > allowed + slack * b.abs().max()).sum())


# --------------------------------------------------------------------------
# the float64 plain versions
# --------------------------------------------------------------------------

def test_stem_plain_f64_within_one_ulp_of_f32():
    images, w, bias = stem_case(0)
    f32 = stem_cuda.stem_plain(images, w, bias)
    f64 = stem_cuda.stem_plain(images, w, bias, F64)
    assert f64.dtype == torch.bfloat16 and f64.shape == f32.shape
    assert torch.equal(f32, stem_cuda.stem_plain(images, w, bias,
                                                 torch.float32))
    assert one_ulp_apart(f32, f64, 2 ** -16) == 0
    # the same bf16 roundings: almost every element equal
    assert (f32 != f64).double().mean() < 0.01


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_plain_f64_within_one_ulp_of_f32(name):
    x, blk = block_case(name, 1)
    f32 = bottleneck_cuda.chain_plain(x, [blk])
    f64 = bottleneck_cuda.chain_plain(x, [blk], F64)
    assert f64.dtype == torch.bfloat16 and f64.shape == f32.shape
    assert torch.equal(f32, bottleneck_cuda._block_plain(x, blk))
    # t1 and t2 are rounded too: where one of them lands an ulp apart,
    # the output moves by that ulp times a weight, more than the output's
    # own ulp where the output is small. So: within one ulp at the
    # output's scale (its largest value), and almost every element equal
    a, b = f32.double(), f64.double()
    assert (a - b).abs().max() <= kb.bf16_ulp(b.abs().max())
    assert (f32 != f64).double().mean() < 0.01


# --------------------------------------------------------------------------
# stand-in kernels: the plain function's float32 output before its last
# rounding, rounded in another way or summed in another order
# --------------------------------------------------------------------------

def mm_seq(a, w):
    return a @ w


def mm_pairwise(a, w, k=16):
    """a @ w in float32 with K summed in slices of k (an MMA step's
    depth), the slices' sums added pairwise: the plain product's terms in
    another order."""
    parts = [a[..., i:i + k] @ w[i:i + k] for i in range(0, a.shape[-1], k)]
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] if i + 1 < len(parts) else parts[i]
                 for i in range(0, len(parts), 2)]
    return parts[0]


def stem_pre(images, w, bias, mm=None):
    """`stem_plain` up to its last rounding; with `mm`, the conv as an
    im2col product through it."""
    b, h, wd, _ = images.shape
    x = images.to(torch.bfloat16).float().permute(0, 3, 1, 2)
    if mm is None:
        y = F.conv2d(x, w.float().permute(3, 2, 0, 1), stride=2, padding=3)
    else:
        cols = F.unfold(x, 7, padding=3, stride=2).transpose(1, 2)
        # unfold's rows run (channel, dy, dx)
        y = mm(cols, w.float().permute(2, 0, 1, 3).reshape(147, -1))
        y = y.transpose(1, 2).reshape(b, -1, (h - 1) // 2 + 1,
                                      (wd - 1) // 2 + 1)
    y = torch.relu(y + bias[None, :, None, None])
    y = F.max_pool2d(F.pad(y, (0, 1, 0, 1), value=float("-inf")), 3, 2)
    return y.permute(0, 2, 3, 1)


def block_pre(x, blk, mm=mm_seq):
    """`_block_plain` up to its last rounding, each product through
    `mm`."""
    b, h, w, _ = x.shape
    xf = x.float()
    t1 = torch.relu(mm(xf, blk["w1"].float()) + blk["b1"]).to(torch.bfloat16)
    m = t1.shape[-1]
    tp = F.pad(t1.float(), (0, 0, 1, 1, 1, 1))
    patches = torch.cat([tp[:, dy:dy + h, dx:dx + w]
                         for dy in range(3) for dx in range(3)], dim=-1)
    t2 = torch.relu(mm(patches, blk["w2"].float().reshape(9 * m, m))
                    + blk["b2"]).to(torch.bfloat16)
    t3 = mm(t2.float(), blk["w3"].float()) + blk["b3"]
    short = mm(xf, blk["ws"].float()) + blk["bs"] if "ws" in blk else xf
    return torch.relu(t3 + short)


def round_toward_zero(pre):
    """float32 -> bf16 by dropping the low 16 bits (exact in bf16)."""
    bits = pre.contiguous().view(torch.int32) & ~0xFFFF
    return bits.view(torch.float32).to(torch.bfloat16)


def plus_quarter_ulp(pre):
    return (pre + 0.25 * kb.bf16_ulp(pre)).to(torch.bfloat16)


def outputs(case, stand_in, seed=2):
    """(stand-in kernel, float32 plain, float64 plain) of one input."""
    if case == "stem":
        images, w, bias = stem_case(seed)
        plain = stem_cuda.stem_plain(images, w, bias)
        ref = stem_cuda.stem_plain(images, w, bias, F64)
        pre = lambda mm=None: stem_pre(images, w, bias, mm)
    else:
        x, blk = block_case(case, seed)
        plain = bottleneck_cuda.chain_plain(x, [blk])
        ref = bottleneck_cuda.chain_plain(x, [blk], F64)
        pre = lambda mm=mm_seq: block_pre(x, blk, mm)
    # the stand-ins' own path, rounded as the plain version rounds, is it
    assert torch.equal(pre().to(torch.bfloat16), plain)
    kernel = {"round_toward_zero": lambda: round_toward_zero(pre()),
              "plus_quarter_ulp": lambda: plus_quarter_ulp(pre()),
              "reordered": lambda: pre(mm_pairwise).to(torch.bfloat16)
              }[stand_in]()
    return kernel, plain, ref


def audit(kernel, plain, ref):
    st = kb.BiasStats()
    st.add(kernel, plain, ref)
    return kb.decided(st)


@pytest.mark.parametrize("case", ["stem", "res2a", "res3b"])
@pytest.mark.parametrize("stand_in", ["round_toward_zero", "plus_quarter_ulp"])
def test_rule_finds_a_planted_lean(case, stand_in):
    row = audit(*outputs(case, stand_in))
    kp = row["kernel_minus_plain"]
    # outputs are >= 0 (ReLU, max-pool): toward zero is down
    sign = -1 if stand_in == "round_toward_zero" else 1
    assert sign * kp["mean_ulp"] > 0.05
    assert not row["rule"]["bias_ok"] and not row["rule"]["unbiased"]
    assert (kp["share_down"] if sign < 0 else kp["share_up"]) > 0.1
    assert row["kernel_vs_f64"]["mean_abs_ulp"] > \
        row["plain_vs_f64"]["mean_abs_ulp"]


def mm_last_pairwise():
    """`mm` for `block_pre` that sums the block's output products (t2 @ w3
    and a projection's x @ ws) pairwise and its first two as the plain
    version does."""
    calls = []

    def mm(a, w):
        calls.append(None)
        return a @ w if len(calls) <= 2 else mm_pairwise(a, w)
    return mm


@pytest.mark.parametrize("case", ["res2a", "res2b", "res3b"])
def test_rule_passes_reordered_sums(case):
    """A stand-in whose output sums run in another float32 order passes
    the rule. Its t1 and t2 are the plain version's: where a stand-in's
    own t1 or t2 lands an ulp apart, many outputs move at once, and at
    these sizes a few dozen such events decide the mean |error| either
    way (a fully reordered stand-in read 0.01-5.2x the plain version's
    over 12 seeds); eight inputs' outputs are pooled."""
    st = kb.BiasStats()
    differ = 0
    for seed in range(8):
        x, blk = block_case(case, seed)
        plain = bottleneck_cuda.chain_plain(x, [blk])
        kernel = block_pre(x, blk, mm_last_pairwise()).to(torch.bfloat16)
        st.add(kernel, plain, bottleneck_cuda.chain_plain(x, [blk], F64))
        differ += int((kernel != plain).sum())
    row = kb.decided(st)
    assert differ > 0            # another function of the same inputs
    assert row["rule"]["unbiased"], row
    assert abs(row["kernel_minus_plain"]["mean_ulp"]) < kb.BIAS_FLOOR_ULP


def test_rule_finds_no_lean_in_a_reordered_stem():
    """The stem's conv as an im2col product with its 147 terms summed
    pairwise: no lean. Its outputs are max-pooled, and the two versions
    differ on a handful of 65,536 elements an input, too few for the mean
    |error| to compare (the rule's second half) at this size."""
    for seed in range(4):
        kernel, plain, ref = outputs("stem", "reordered", seed)
        row = audit(kernel, plain, ref)
        assert row["rule"]["bias_ok"], row
        assert row["kernel_minus_plain"]["share_differ"] < 1e-3


def test_stats_in_ulps_of_the_f64_value():
    """Hand-made elements: one ulp up, one down, one equal, one next to 0
    (where the unit is half the larger value's ulp, not the f64 value's)."""
    ref = torch.tensor([1.0, 2.0, 3.0, 2.0 ** -20], dtype=torch.bfloat16)
    kernel = torch.tensor([1.0 + 2 ** -7, 2.0 - 2 ** -7, 3.0, 2.0 ** -12],
                          dtype=torch.bfloat16)
    row = audit(kernel, ref.clone(), ref)
    k = row["kernel_vs_f64"]
    # ulps: at 1.0 2^-7; below 2.0 the ulp of 2.0 (2^-6); at 2^-12
    # against 2^-20 half the ulp of 2^-12 (2^-20), not 2^-20's (2^-27)
    want = [1.0, -0.5, 0.0, (2.0 ** -12 - 2.0 ** -20) / 2.0 ** -20]
    assert k["mean_ulp"] == pytest.approx(sum(want) / 4)
    assert k["max_abs_ulp"] == pytest.approx(max(map(abs, want)))
    assert k["share_up"] == 0.5 and k["share_down"] == 0.25
    # in the f64 value's own ulp the last element weighs 2^7 x more
    assert k["f64_ulp"]["max_abs_ulp"] == pytest.approx(
        (2.0 ** -12 - 2.0 ** -20) / 2.0 ** -27)
    assert row["plain_vs_f64"]["mean_abs_ulp"] == 0.0
    assert not row["rule"]["abs_ok"]


# --------------------------------------------------------------------------
# the tool end to end
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A tiny flagship-proof root trained on the CPU (`--tiny`)."""
    from maskrcnn_tpu_torch.tools import flagship_proof

    root = str(tmp_path_factory.mktemp("proof"))
    assert flagship_proof.main([
        "--tiny", "--arch", "resnet50", "--image-size", "128", "--steps",
        "1", "--batch", "1", "--train-images", "2", "--val-images", "3",
        "--device", "cpu", "--root", root]) == 0
    return root


def test_tool_runs_on_a_tiny_root(tiny_root, capsys):
    out = os.path.join(tiny_root, "kernel_bias.json")
    assert kb.main(["--root", tiny_root, "--images", "3", "--batch", "2",
                    "--device", "cpu", "--out", out]) == 0
    with open(out) as f:
        report = json.load(f)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == report
    assert report["device"] == "cpu" and report["seed"] == 0
    assert report["images"] == 3 and report["rule"] == kb.RULE
    assert report["tf32_in_audit"] is False
    assert [r["name"] for r in report["rows"]] == [
        "K3_stem", "K4_res2a", "K4_res2b", "K4_res2c", "K4_res3b",
        "K4_res3c", "K4_res3d"]
    # 3 real images of the two batches (the padding image is left out)
    assert report["rows"][0]["elements"] == 3 * 32 * 32 * 64
    assert report["rows"][1]["elements"] == 3 * 32 * 32 * 256
    assert report["rows"][-1]["elements"] == 3 * 16 * 16 * 512
    for row in report["rows"]:
        # on the CPU the op is the plain version: nothing differs from it
        assert row["kernel_minus_plain"]["share_differ"] == 0.0
        assert row["kernel_vs_f64"] == row["plain_vs_f64"]
        assert row["rule"]["unbiased"] and row["rule_f64_ulp"]["unbiased"]
    assert report["unbiased"]


def test_tool_records_the_production_calls(tiny_root):
    """One K3 and two K4 calls a forward, at the stem's and the chains'
    inputs: the forward's own tensors."""
    from maskrcnn_tpu_torch.core.config import MaskRCNNConfig
    from maskrcnn_tpu_torch.pipeline.detector import MaskRCNNDetector

    cfg = MaskRCNNConfig.from_json(os.path.join(tiny_root,
                                                "config_production.json"))
    det = MaskRCNNDetector.from_checkpoint(
        cfg, os.path.join(tiny_root, "checkpoint.npz"), device="cpu")
    (canvases, n), = kb.val_batches(tiny_root, cfg.image_height, 2, 2)
    calls = {"stem": [], "chain": []}
    with kb.recording(calls, any_device=True):
        det.run_batch(torch.from_numpy(canvases))
    assert n == 2 and len(calls["stem"]) == 1 and len(calls["chain"]) == 2
    assert calls["stem"][0][0].shape == (2, 128, 128, 3)
    assert [x.shape[-1] for x, _ in calls["chain"]] == [64, 512]
    assert [len(b) for _, b in calls["chain"]] == [3, 3]
    # the gates are back: on the CPU the forward takes its layers again
    calls = {"stem": [], "chain": []}
    with kb.recording(calls, any_device=False):
        det.run_batch(torch.from_numpy(canvases))
    assert calls == {"stem": [], "chain": []}
