"""The K3-K6 bias audit (`maskrcnn_tpu_torch/tools/kernel_bias.py`) on the
CPU: the float64 plain versions against the float32 ones, the audit's
statistics and rule against stand-in kernels with a planted lean and one
that only reorders its float32 sums, and the tool end to end on a tiny
flagship-proof root.

This file imports neither JAX nor the JAX package. Inputs are made with
numpy from a seed; the sizes are `tiny_test_config()`'s (R50 @ 128^2:
the stem's 32^2 output, res2 at 32^2, res3 at 16^2), at full width; the
fused heads' float64 versions at 8 channels, their rule cases at full
depth (K5's dense 1 12544 deep, K6's 3x3 conv 2304 deep) and narrow
outputs."""

import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from maskrcnn_tpu_torch.core.config import tiny_test_config
from maskrcnn_tpu_torch.io.weights import params_from_numpy
from maskrcnn_tpu_torch.models import heads
from maskrcnn_tpu_torch.ops import bottleneck_cuda, roi_align, stem_cuda
from maskrcnn_tpu_torch.ops import roi_align_cuda as rac
from maskrcnn_tpu_torch.tools import kernel_bias as kb
from tests.torch_support import stage_params, stem_params
from tests.torch_support import one_thread  # noqa: F401  (autouse)

F64 = torch.float64


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


def head_case(kind, seed, c=8, n=16, fc=64, nc=5, b=2, size=32):
    """The arguments of K5's (`kind` "classifier": pool 7, dense widths
    49 c -> fc -> fc -> 512 lanes) or K6's plain version ("mask": pool 14,
    c channels, with class ids): a (b, size >> l, size >> l, c) bf16
    pyramid, b x n ROIs (every seventh a zero row), BN statistics from the
    seed."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    feats = [torch.from_numpy(rng.standard_normal(
        (b, size >> l, size >> l, c)).astype(np.float32)).to(torch.bfloat16)
        for l in range(4)]
    yx1 = rng.uniform(0, 0.7, (b * n, 2))
    rois = np.concatenate([yx1, np.minimum(
        yx1 + rng.uniform(0.05, 0.6, (b * n, 2)), 1.0)], -1)
    rois[5::7] = 0.0
    crop = 7 if kind == "classifier" else 14
    prep = roi_align.prepare(torch.from_numpy(rois.astype(np.float32)),
                             [(f.shape[1], f.shape[2]) for f in feats],
                             (4 * size, 4 * size), 224.0, crop)
    params = (heads.init_classifier_head(gen, nc, c, 7, fc) if crop == 7
              else heads.init_mask_head(gen, nc, c, c))
    for w in params.values():
        if "moving_variance" in w:
            u = lambda lo, hi: torch.from_numpy(rng.uniform(
                lo, hi, w["gamma"].shape[0]).astype(np.float32))
            w.update(gamma=u(0.5, 1.5), beta=u(-0.2, 0.2),
                     moving_mean=u(-0.2, 0.2), moving_variance=u(0.5, 2.0))
    if crop == 7:
        return (feats, *prep, n,
                rac.pack_classifier_head(params, nc, torch.bfloat16))
    ids = torch.from_numpy(rng.integers(1, nc, b * n).astype(np.int32))
    return (feats, *prep, n, rac.pack_mask_head(params, torch.bfloat16), ids)


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


def within_one_ulp_at_scale(a, b):
    """|a - b| no larger than one bf16 ulp of max |b|: where an earlier
    rounding point lands an ulp apart, later values move by that ulp times
    a weight, more than their own ulp where they are small."""
    a, b = a.double(), b.double()
    return bool((a - b).abs().max() <= kb.bf16_ulp(b.abs().max()))


def test_classifier_head_plain_f64_within_one_ulp_of_f32():
    args = head_case("classifier", 0)
    h1, out = rac._classifier_head_plain(*args)
    h1_64, out_64 = rac._classifier_head_plain(*args, F64)
    # the default is float32, and the helper is the plain version
    assert torch.equal(out, rac.classifier_head_plain(*args))
    assert torch.equal(out, rac.classifier_head_plain(*args, torch.float32))
    assert out.dtype == torch.float32 and out_64.dtype == F64
    assert h1.dtype == h1_64.dtype == torch.bfloat16
    assert h1.shape == (32, 64) and out.shape == (32, rac.HEAD_OUT)
    # h1, the first rounding point: within one ulp element by element
    assert one_ulp_apart(h1, h1_64, 2 ** -16) == 0
    assert (h1 != h1_64).double().mean() < 0.01
    assert within_one_ulp_at_scale(out, out_64)


def test_mask_head_plain_f64_within_one_ulp_of_f32():
    args = head_case("mask", 3)
    acts, masks = rac._mask_head_plain(*args)
    acts_64, masks_64 = rac._mask_head_plain(*args, F64)
    assert torch.equal(masks, rac.mask_head_plain(*args))
    assert torch.equal(masks, rac.mask_head_plain(*args, torch.float32))
    assert masks.dtype == torch.float32 and masks_64.dtype == F64
    assert masks.shape == (32, 28, 28) and len(acts) == len(acts_64) == 4
    # each conv output is a rounding point; the first is held element by
    # element, the later ones carry the earlier ones' ulps
    assert one_ulp_apart(acts[0], acts_64[0], 2 ** -16) == 0
    for a, a64 in zip(acts, acts_64):
        assert a.dtype == a64.dtype == torch.bfloat16
        assert within_one_ulp_at_scale(a, a64)
        assert (a != a64).double().mean() < 0.01
    assert within_one_ulp_at_scale(masks, masks_64)


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


def rz_f32(x):
    """float64 -> float32, rounded toward zero."""
    y = x.to(torch.float32)
    return torch.where(y.double().abs() > x.abs(),
                       torch.nextafter(y, torch.zeros_like(y)), y)


def mm_tensor_cores(a, w, k=16):
    """a @ w as the tensor cores accumulate it (`wgmma` / `mma.sync` d +=
    A * B): each k16 step's products summed exactly and added to the
    float32 running sum, the result rounded toward zero."""
    a64, w64 = a.double(), w.double()
    s = torch.zeros(a.shape[:-1] + w.shape[-1:], dtype=torch.float32)
    for i in range(0, a.shape[-1], k):
        s = rz_f32(s.double() + a64[..., i:i + k] @ w64[i:i + k])
    return s


# The fused heads' layers a rule case stands in for, at full depth:
# (kind, head_case arguments)
HEAD_LAYERS = {"k5_dense1": ("classifier", {"c": 256, "n": 64, "fc": 256}),
               "k6_conv": ("mask", {"c": 256, "n": 2})}


def head_layer(case, seed):
    """(pre, plain, f64) of K5's dense 1 (h1) or K6's first 3x3 conv on
    one input: `pre(mm)` is the plain version's layer up to its bf16
    rounding with its product through `mm`; plain and f64 are the plain
    versions' own outputs there, valid ROIs only."""
    kind, kw = HEAD_LAYERS[case]
    args = head_case(kind, seed, **kw)
    valid = args[4]
    pooled = rac.roi_align_plain(*args[:6]).float()
    if kind == "classifier":
        x = pooled.reshape(pooled.shape[0], -1)
        w, bias = args[6]["w1"].float(), args[6]["b1"]
        plain, ref = (rac._classifier_head_plain(*args, acc)[0]
                      for acc in (torch.float32, F64))
    else:
        p = pooled.shape[1]
        xp = F.pad(pooled, (0, 0, 1, 1, 1, 1))
        x = torch.cat([xp[:, dy:dy + p, dx:dx + p]
                       for dy in range(3) for dx in range(3)], dim=-1)
        w, bias = args[6]["wconv"][0].float(), args[6]["bconv"][0]
        plain, ref = (rac._mask_head_plain(*args, acc)[0][0]
                      for acc in (torch.float32, F64))
    return (lambda mm=mm_seq: torch.relu(mm(x, w) + bias)[valid],
            plain[valid], ref[valid])


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
    elif case in HEAD_LAYERS:
        pre, plain, ref = head_layer(case, seed)
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
              }[stand_in]
    if case in HEAD_LAYERS and stand_in == "round_toward_zero":
        # toward zero over the long K, where the heads' kernels rounded
        kernel = lambda: pre(mm_tensor_cores).to(torch.bfloat16)
    return kernel(), plain, ref


def audit(kernel, plain, ref):
    st = kb.BiasStats()
    st.add(kernel, plain, ref)
    return kb.decided(st)


@pytest.mark.parametrize("case", ["stem", "res2a", "res3b", "k5_dense1",
                                  "k6_conv"])
@pytest.mark.parametrize("stand_in", ["round_toward_zero", "plus_quarter_ulp"])
def test_rule_finds_a_planted_lean(case, stand_in):
    row = audit(*outputs(case, stand_in))
    kp = row["kernel_minus_plain"]
    if case in HEAD_LAYERS and stand_in == "round_toward_zero":
        # each k16 step's sum rounded toward zero over 784 (144) steps:
        # the h1 (conv) values that flip flip down more often than up,
        # too few of them for the lean to pass the 0.01-ulp floor at this
        # size, while the mean |error| is several times the plain
        # version's: the rule's second half finds it
        assert not row["rule"]["abs_ok"] and not row["rule"]["unbiased"]
        assert row["rule"]["abs_ratio"] > 3
        assert kp["share_down"] > kp["share_up"]
        return
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


@pytest.mark.parametrize("case", ["res2a", "res2b", "res3b", "k5_dense1",
                                  "k6_conv"])
def test_rule_passes_reordered_sums(case):
    """A stand-in whose output sums run in another float32 order passes
    the rule. Its t1 and t2 are the plain version's: where a stand-in's
    own t1 or t2 lands an ulp apart, many outputs move at once, and at
    these sizes a few dozen such events decide the mean |error| either
    way (a fully reordered stand-in read 0.01-5.2x the plain version's
    over 12 seeds); eight inputs' outputs are pooled. The heads' cases
    are one layer each (K5's h1, K6's first conv), its long K summed in
    slices of 16 added pairwise."""
    st = kb.BiasStats()
    differ = 0
    for seed in range(8):
        if case in HEAD_LAYERS:
            kernel, plain, ref = outputs(case, "reordered", seed)
            st.add(kernel, plain, ref)
            differ += int((kernel != plain).sum())
            continue
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
        "K4_res3c", "K4_res3d", "K5_dense1", "K5_logits", "K5_deltas",
        "K6_conv3", "K6_conv4", "K6_masks"]
    rows = {r["name"]: r for r in report["rows"]}
    # 3 real images of the two batches (the padding image is left out)
    assert rows["K3_stem"]["elements"] == 3 * 32 * 32 * 64
    assert rows["K4_res2a"]["elements"] == 3 * 32 * 32 * 256
    assert rows["K4_res3d"]["elements"] == 3 * 16 * 16 * 512
    # K5: the valid ROIs of the real images (64 proposals an image), h1
    # 1024 wide, the classes' logits and deltas; K6: their valid
    # detections (16 an image), whose number the tiny checkpoint decides
    with open(os.path.join(tiny_root, "config_production.json")) as f:
        nc = json.load(f)["num_classes"]
    rois = rows["K5_dense1"]["elements"] // 1024
    assert 0 < rois <= 3 * 64 and rows["K5_dense1"]["elements"] == rois * 1024
    assert rows["K5_logits"]["elements"] == rois * nc
    assert rows["K5_deltas"]["elements"] == rois * 4 * nc
    dets = rows["K6_masks"]["elements"] // (28 * 28)
    assert dets <= 3 * 16 and rows["K6_masks"]["elements"] == dets * 784
    for name in ("K6_conv3", "K6_conv4"):
        assert rows[name]["elements"] == dets * 14 * 14 * 256
    for row in report["rows"]:
        # on the CPU the op is the plain version: nothing differs from it
        assert row["kernel_minus_plain"]["share_differ"] == 0.0
        assert row["kernel_vs_f64"] == row["plain_vs_f64"]
        assert row["rule"]["unbiased"] and row["rule_f64_ulp"]["unbiased"]
    assert report["unbiased"]


def test_tool_records_the_production_calls(tiny_root):
    """One K3 and two K4 calls a forward, at the stem's and the chains'
    inputs: the forward's own tensors; with the fused heads, also one K5
    and one K6 call (the names `ops/roi_align.py` calls them by)."""
    from maskrcnn_tpu_torch.core.config import MaskRCNNConfig
    from maskrcnn_tpu_torch.pipeline.detector import MaskRCNNDetector
    from maskrcnn_tpu_torch.tools.proof_numerics import fused_heads

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

    fused = MaskRCNNDetector(fused_heads(cfg), det.params, device="cpu")
    calls = {"stem": [], "chain": []}
    with kb.recording(calls, any_device=True):
        fused.run_batch(torch.from_numpy(canvases))
    assert len(calls["stem"]) == 1 and len(calls["chain"]) == 2
    (cls,), (msk,) = calls["classifier_head"], calls["mask_head"]
    feats, ys, xs, level, valid, n, head = cls
    assert len(feats) == 4 and feats[0].shape == (2, 32, 32, 256)
    assert ys.shape == xs.shape == (2 * 64, 7) and n == 64
    assert level.shape == valid.shape == (2 * 64,) and valid.any()
    assert head["w1"].shape == (7 * 7 * 256, 1024)
    feats, ys, xs, level, valid, n, mask, class_ids = msk
    assert ys.shape == (2 * 16, 14) and n == 16
    assert class_ids.shape == (2 * 16,) and mask["wconv"].shape[0] == 4

    # the gates are back: on the CPU the forward takes its layers again
    calls = {"stem": [], "chain": []}
    with kb.recording(calls, any_device=False):
        det.run_batch(torch.from_numpy(canvases))
    assert calls == {"stem": [], "chain": []}
