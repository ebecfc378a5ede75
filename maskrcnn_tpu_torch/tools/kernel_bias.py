"""Do K3-K6 lean away from their plain versions? An elementwise audit at a
trained checkpoint's weights, on the activations its forward hands the
kernels.

    python3 -m maskrcnn_tpu_torch.tools.kernel_bias --root DIR \\
        [--images 64] [--batch 8] [--out FILE] [--device cpu]

`--root` is a root that `tools/flagship_proof.py` has trained in
(`checkpoint.npz`, `config_production.json`, its synthetic COCO set). The
tool runs the production forward (`MaskRCNNDetector.run_batch`) over the
first `--images` val images, in id order as `cli evaluate` takes them, in
batches of `--batch` (the proof's evaluate batch), and records what the
forward hands K3 (`stem_cuda.stem`) and each K4 chain
(`bottleneck_cuda.fused_bottleneck_chain`). A second forward over the same
batches, the production config with both fused heads on
(`proof_numerics.fused_heads`), records what it hands K5 and K6 (the names
`roi_classifier_head` and `roi_mask_head` in `ops/roi_align.py`, which
that module imports from `ops/roi_align_cuda.py`). Each recorded input
then goes through three versions of the same function:

  kernel  the op: the CUDA kernel on the card (on the CPU its plain
          version, so every reading there is 0: a run of the tool's path)
  plain   the plain PyTorch version, float32 sums, TF32 off (the
          `production_plain_k3k4` variant of `proof_numerics.py` runs it
          with PyTorch's default, TF32 on in cuDNN: K3's conv then sums on
          the tensor cores)
  f64     the plain version with float64 sums and the same bf16 roundings
          (images and output; for K4 x, t1, t2 and the output; for K5 the
          pool, h1 and h2; for K6 the pool, each conv's output and the
          class row): the scheme's own rounding and no other

Rows: K3, and each of K4's six blocks (res2 a, b, c; res3 b, c, d) alone,
each fed the plain chain's output of the block before, so that a row
holds that block's own error and nothing that earlier blocks carry on.
K5: its logits (lanes [0, nc)) and box deltas (lanes [128, 128 + 4 nc))
and, to say where an error starts, h1 (`K5_dense1`: the 12544-deep sum,
bf16, read from the kernel's scratch); K6: its masks and the outputs of
its third and fourth 3x3 convs (`K6_conv3`, `K6_conv4`, the kernel's two
activation buffers). These rows carry what the head's earlier layers
pass on, in each version alike. K5 and K6 rows count the valid ROIs and
detections of the real images only (padded rows pool to zero). Each row
gives, over every element of the real images of each batch, for
the kernel and for the plain version against f64 the mean signed error
with its standard error, the mean and the max |error| and the shares of
elements above and below; and for kernel - plain the mean signed
difference with its standard error, the share of elements that differ
and the max |diff|.

Errors are in bf16 ulps of the f64 value (`bf16_ulp`), the ulp taken no
smaller than half the ulp of the larger of the kernel's and the plain
value (`ulp_unit`). The two differ only where a float32 sum's error is as
large as the value itself (cancellation, or a ReLU input next to 0):
there the f64 value can lie any distance below the sums' error, so one
element's error in its own ulp can outweigh every other's, and a mean
over them follows its largest element, not the kernel. The bound caps an
error at ~512 ulps. Each side's readings in the f64 value's own ulp are kept
beside (`f64_ulp`), not used by the rule.

The decision rule (`decide`): a kernel is unbiased against its plain
version when in every row both hold:
  |mean(kernel - plain)| <= max(4 standard errors, 0.01 ulp), and
  the kernel's mean |error| against f64 <= 1.05 x the plain version's.

On the CPU the gates of `models/resnet.py`, which ask for a CUDA tensor,
are opened for the run, so the recording sees the production forward's
calls there too (the fused heads need no gate: on the CPU their op is the
plain version). Prints one JSON object last; exits 0 whatever the
verdict (the report's `unbiased`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time

import numpy as np
import torch

BIAS_SE = 4.0          # |mean(kernel - plain)| <= BIAS_SE standard errors,
BIAS_FLOOR_ULP = 0.01  # or this many ulps, whichever is larger
ABS_RATIO = 1.05       # kernel mean |err| <= ABS_RATIO x plain's
RULE = (f"unbiased when in every row |mean(kernel - plain)| <= "
        f"max({BIAS_SE:g} standard errors, {BIAS_FLOOR_ULP:g} ulp) and "
        f"mean |kernel - f64| <= {ABS_RATIO:g} x mean |plain - f64| "
        f"(bf16 ulps of the f64 value, no smaller than half the ulp of "
        f"the larger of |kernel|, |plain|)")
CHUNK = 1 << 24        # elements per pass of `BiasStats.add`


def bf16_ulp(x):
    """The spacing of bfloat16 numbers at |x|: 2^(e-8) for |x| in
    [2^(e-1), 2^e)."""
    _, e = torch.frexp(x.abs())
    return torch.ldexp(torch.ones_like(x), e - 8)


def ulp_unit(kernel, plain, ref):
    """The rule's unit: the f64 value's bf16 ulp, but no smaller than
    half the ulp of the larger of |kernel|, |plain| (where that is not
    0). Float64 tensors."""
    m = torch.maximum(kernel.abs(), plain.abs())
    floor = torch.where(m > 0, bf16_ulp(m) / 2, torch.zeros_like(m))
    return torch.maximum(bf16_ulp(ref), floor)


def _moments(n, s) -> dict:
    """(A row that saw no elements reads 0 throughout.)"""
    n = max(n, 1)
    mean = s["sum"] / n
    var = max(s["sq"] / n - mean * mean, 0.0)
    return {"mean_ulp": mean, "se_ulp": math.sqrt(var / max(n - 1, 1)),
            "mean_abs_ulp": s["abs"] / n, "max_abs_ulp": s["max"]}


class BiasStats:
    """Float64 running sums of kernel - f64, plain - f64 and kernel -
    plain over the batches `add` sees: in the rule's unit (`ulp_unit`)
    and in the f64 value's own bf16 ulp."""

    SIDES = ("kernel_vs_f64", "plain_vs_f64", "kernel_minus_plain")
    UNITS = ("rule", "f64_ulp")

    def __init__(self):
        self.n = 0
        self.sums = {(side, unit): {"sum": 0.0, "sq": 0.0, "abs": 0.0,
                                    "max": 0.0, "up": 0, "down": 0}
                     for side in self.SIDES for unit in self.UNITS}

    def add(self, kernel, plain, ref) -> None:
        """Three outputs of one input: the kernel's, the float32 plain
        version's and the float64 one's (no elements: nothing added)."""
        if not (kernel.shape == plain.shape == ref.shape):
            raise ValueError(f"shapes differ: {tuple(kernel.shape)}, "
                             f"{tuple(plain.shape)}, {tuple(ref.shape)}")
        if kernel.numel() == 0:
            return
        for k, p, r in zip(*(t.reshape(-1).split(CHUNK)
                             for t in (kernel, plain, ref))):
            k, p, r = k.double(), p.double(), r.double()
            for unit, ulp in zip(self.UNITS, (ulp_unit(k, p, r),
                                              bf16_ulp(r))):
                for side, diff in zip(self.SIDES, (k - r, p - r, k - p)):
                    d = diff / ulp
                    s = self.sums[side, unit]
                    s["sum"] += d.sum().item()
                    s["sq"] += (d * d).sum().item()
                    a = d.abs()
                    s["abs"] += a.sum().item()
                    s["max"] = max(s["max"], a.max().item())
                    s["up"] += int((d > 0).sum())
                    s["down"] += int((d < 0).sum())
            self.n += k.numel()

    def summary(self) -> dict:
        n = self.n
        out = {"elements": n}
        for side in self.SIDES:
            s = self.sums[side, "rule"]
            out[side] = {**_moments(n, s),
                         "share_up": s["up"] / max(n, 1),
                         "share_down": s["down"] / max(n, 1),
                         "f64_ulp": _moments(n, self.sums[side, "f64_ulp"])}
        kp = out["kernel_minus_plain"]
        kp["share_differ"] = kp["share_up"] + kp["share_down"]
        return out


def decide(row: dict, unit: str = "rule") -> dict:
    """The rule's readings for one `BiasStats.summary` row; `unit`
    "f64_ulp" reads the same rule off the f64 value's own ulp (kept for
    the record, it decides nothing)."""
    pick = (lambda side: row[side]) if unit == "rule" else (
        lambda side: row[side]["f64_ulp"])
    kp = pick("kernel_minus_plain")
    bound = max(BIAS_SE * kp["se_ulp"], BIAS_FLOOR_ULP)
    k_abs = pick("kernel_vs_f64")["mean_abs_ulp"]
    p_abs = pick("plain_vs_f64")["mean_abs_ulp"]
    bias_ok = abs(kp["mean_ulp"]) <= bound
    abs_ok = k_abs <= ABS_RATIO * p_abs
    return {"bias_bound_ulp": bound, "bias_ok": bias_ok,
            "abs_ratio": k_abs / p_abs if p_abs else (
                1.0 if k_abs == 0 else math.inf),
            "abs_ok": abs_ok, "unbiased": bias_ok and abs_ok}


def decided(stats: BiasStats) -> dict:
    """A summary row with the rule's readings (`rule`) and the same rule
    in the f64 value's own ulp (`rule_f64_ulp`, for the record)."""
    row = stats.summary()
    row["rule"] = decide(row)
    row["rule_f64_ulp"] = decide(row, "f64_ulp")
    return row


# ---------------------------------------------------------------------------
# the three versions of each function
# ---------------------------------------------------------------------------

STEM_ROW = ("K3_stem", "maskrcnn_tpu_torch/csrc/stem.cu",
            "maskrcnn_tpu/ops/stem_pallas.py:197")
CHAIN_SOURCE = ("maskrcnn_tpu_torch/csrc/bottleneck.cu",
                "maskrcnn_tpu/ops/bottleneck_pallas.py:213")


def chain_rows() -> list[tuple[int, str]]:
    """(stage, letter) of each K4 block, in the forward's order."""
    from maskrcnn_tpu_torch.models.resnet import FUSED_CHAINS

    return [(stage, letter) for (stage, _), letters
            in sorted(FUSED_CHAINS.items()) for letter in letters]


def audit_stem(stats: BiasStats, images, w, bias) -> None:
    from maskrcnn_tpu_torch.ops import stem_cuda

    kernel = stem_cuda.stem(images, w, bias)
    plain = stem_cuda.stem_plain(images, w, bias)
    ref = stem_cuda.stem_plain(images, w, bias, torch.float64)
    stats.add(kernel, plain, ref)


def audit_chain(stats: list[BiasStats], x, blocks) -> None:
    """Each block alone: the kernel, plain and f64 on the same bf16 input,
    the plain output passed on to the next block."""
    from maskrcnn_tpu_torch.ops import bottleneck_cuda as bc

    x = x.to(torch.bfloat16)
    for st, blk in zip(stats, blocks):
        kernel = bc.fused_bottleneck_chain(x, [blk])
        plain = bc.chain_plain(x, [blk])
        ref = bc.chain_plain(x, [blk], torch.float64)
        st.add(kernel, plain, ref)
        del kernel, ref
        x = plain


HEAD_REPLACES = "maskrcnn_tpu/ops/roi_align_pallas.py:716"
K5_ROWS = ("K5_dense1", "K5_logits", "K5_deltas")
K6_ROWS = ("K6_conv3", "K6_conv4", "K6_masks")
HEAD_SOURCES = {"K5": "maskrcnn_tpu_torch/csrc/roi_classifier_head.cu",
                "K6": "maskrcnn_tpu_torch/csrc/roi_mask_head.cu"}


def head_stats() -> dict:
    return {name: BiasStats() for name in K5_ROWS + K6_ROWS}


def audit_classifier_head(stats: dict, features, ys, xs, level, valid,
                          rois_per_image, head, num_classes, keep) -> None:
    """K5's rows over the ROIs `keep` ((M,) bool): the kernel (its h1
    scratch and its rows), the float32 and the float64 plain version."""
    from maskrcnn_tpu_torch.ops import roi_align_cuda as rac

    args = ([f.contiguous() for f in features], ys, xs, level, valid,
            int(rois_per_image), head)
    kernel = (rac._classifier_head_cuda(*args) if ys.is_cuda
              else rac._classifier_head_plain(*args))
    plain = rac._classifier_head_plain(*args)
    ref = rac._classifier_head_plain(*args, torch.float64)
    h1, out = zip(kernel, plain, ref)
    stats["K5_dense1"].add(*(t[keep] for t in h1))
    out = [t[keep] for t in out]
    for name, lanes in (("K5_logits", slice(0, num_classes)),
                        ("K5_deltas", slice(128, 128 + 4 * num_classes))):
        stats[name].add(*(t[:, lanes] for t in out))


def audit_mask_head(stats: dict, features, ys, xs, level, valid,
                    rois_per_image, mask, class_ids, keep) -> None:
    """K6's rows over the detections `keep` ((M,) bool): the kernel (its
    conv 3 and conv 4 buffers and its masks), the float32 and the float64
    plain version."""
    from maskrcnn_tpu_torch.ops import roi_align_cuda as rac

    args = ([f.contiguous() for f in features], ys, xs, level, valid,
            int(rois_per_image), mask, class_ids)

    def plain(acc):
        acts, masks = rac._mask_head_plain(*args, acc)
        return acts[2:], masks

    outs = [rac._mask_head_cuda(*args) if ys.is_cuda else plain(torch.float32),
            plain(torch.float32), plain(torch.float64)]
    for i, name in enumerate(("K6_conv3", "K6_conv4")):
        stats[name].add(*(acts[i][keep] for acts, _ in outs))
    stats["K6_masks"].add(*(masks[keep] for _, masks in outs))


def head_rows(n, rois_per_image, valid):
    """(M,) bool: the valid ROIs (or detections) of the batch's first `n`
    images."""
    return valid & (torch.arange(valid.numel(), device=valid.device)
                    < n * rois_per_image)


# ---------------------------------------------------------------------------
# recording the production forward's calls
# ---------------------------------------------------------------------------

def _stem_gate_any_device(images, dtype):
    """`stem_cuda.stem_supported` without its device test."""
    return (dtype == torch.bfloat16 and images.shape[1] % 32 == 0
            and images.shape[2] % 32 == 0)


def _chain_gate_any_device(params, stage, letters, x, dtype):
    """`resnet._kernel_chain` without its device test."""
    from maskrcnn_tpu_torch.ops import bottleneck_cuda as bc

    if dtype != torch.bfloat16:
        return None
    with torch.no_grad():
        blocks = bc.fold_bottleneck_chain(params, stage, letters)
    shape = tuple(x.shape)
    for blk in blocks:
        if not bc.block_supported(shape, blk):
            return None
        shape = shape[:3] + (blk["w3"].shape[1],)
    return blocks


@contextlib.contextmanager
def recording(calls: dict, any_device: bool):
    """K3's, K4's, K5's and K6's ops wrapped to append their inputs to
    `calls["stem"]` / `calls["chain"]` / `calls["classifier_head"]` /
    `calls["mask_head"]` (the last two made at their first call); with
    `any_device`, K3's and K4's gates opened on the CPU too."""
    from maskrcnn_tpu_torch.models import resnet
    from maskrcnn_tpu_torch.ops import bottleneck_cuda as bc, roi_align
    from maskrcnn_tpu_torch.ops import stem_cuda
    from maskrcnn_tpu_torch.tools.proof_numerics import _patched

    stem, chain = stem_cuda.stem, bc.fused_bottleneck_chain
    cls_head, mask_head = roi_align.roi_classifier_head, \
        roi_align.roi_mask_head

    def rec_stem(images, w, bias):
        calls["stem"].append((images, w, bias))
        return stem(images, w, bias)

    def rec_chain(x, blocks):
        calls["chain"].append((x, blocks))
        return chain(x, blocks)

    def rec_cls(*args):
        calls.setdefault("classifier_head", []).append(args)
        return cls_head(*args)

    def rec_mask(*args):
        calls.setdefault("mask_head", []).append(args)
        return mask_head(*args)

    # ops/roi_align.py calls the heads by the names it imported
    subs = [(stem_cuda, "stem", rec_stem),
            (bc, "fused_bottleneck_chain", rec_chain),
            (roi_align, "roi_classifier_head", rec_cls),
            (roi_align, "roi_mask_head", rec_mask)]
    if any_device:
        subs += [(stem_cuda, "stem_supported", _stem_gate_any_device),
                 (resnet, "_kernel_chain", _chain_gate_any_device)]
    with _patched(*subs):
        yield


def val_batches(root, size, n_images, batch):
    """(canvases (batch, S, S, 3) float32, real count) over the first
    `n_images` val images of the proof's set, in id order, the last batch
    padded with zeros as `detect_canvases` pads it."""
    from maskrcnn_tpu_torch.evalkit.coco import COCODataset
    from maskrcnn_tpu_torch.pipeline.loader import PrefetchLoader

    ann_dir = os.path.join(root, "data/coco")
    dataset = COCODataset.from_dir(ann_dir)
    items = [(im.id, os.path.join(ann_dir, "val2017", im.file_name))
             for im in dataset.iter_images(limit=n_images, sort_by_id=True)]
    chunk = []
    for _, canvas, _ in PrefetchLoader(items, size):
        chunk.append(canvas)
        if len(chunk) == batch:
            yield np.stack(chunk), batch
            chunk = []
    if chunk:
        n = len(chunk)
        chunk += [np.zeros_like(chunk[0])] * (batch - n)
        yield np.stack(chunk), n


def _forward_calls(detector, canvases, any_device, want: dict) -> dict:
    """The calls one forward made, checked against `want` ({key: count})."""
    calls = {"stem": [], "chain": [], "classifier_head": [], "mask_head": []}
    with recording(calls, any_device):
        detector.run_batch(torch.from_numpy(canvases))
    made = {k: len(v) for k, v in calls.items()}
    if made != want:
        raise RuntimeError(f"the forward made {made} kernel calls (expected "
                           f"{want}): not the path the audit reads")
    return calls


def run_audit(detector, batches) -> list[dict]:
    """The rows of `decide`d `BiasStats` over `batches` ((canvases, real
    count) pairs): K3/K4 through `detector`'s production forward, K5/K6
    through the same weights' fused-head forward (PyTorch's TF32 settings
    as they are), each audited with TF32 off."""
    from maskrcnn_tpu_torch.pipeline.detector import MaskRCNNDetector
    from maskrcnn_tpu_torch.tools.flagship_proof import NoTF32
    from maskrcnn_tpu_torch.tools.proof_numerics import fused_heads

    fused = MaskRCNNDetector(fused_heads(detector.config), detector.params,
                             device=detector.device)
    nc = detector.config.num_classes
    stem_stats = BiasStats()
    chain_keys = chain_rows()
    chain_stats = [BiasStats() for _ in chain_keys]
    heads = head_stats()
    any_device = detector.device.type != "cuda"
    for canvases, n in batches:
        calls = _forward_calls(detector, canvases, any_device, {
            "stem": 1, "chain": 2, "classifier_head": 0, "mask_head": 0})
        with torch.no_grad(), NoTF32():
            images, w, bias = calls["stem"][0]
            audit_stem(stem_stats, images[:n], w, bias)
            i = 0
            for x, blocks in calls["chain"]:
                audit_chain(chain_stats[i:i + len(blocks)], x[:n], blocks)
                i += len(blocks)
        del calls
        calls = _forward_calls(fused, canvases, any_device, {
            "stem": 1, "chain": 2, "classifier_head": 1, "mask_head": 1})
        with torch.no_grad(), NoTF32():
            args = calls["classifier_head"][0]
            audit_classifier_head(heads, *args, nc,
                                  head_rows(n, args[5], args[4]))
            args = calls["mask_head"][0]
            audit_mask_head(heads, *args, head_rows(n, args[5], args[4]))
        del calls, args
    rows = []
    for (name, source, replaces), st in (
            [(STEM_ROW, stem_stats)]
            + [((f"K4_res{stage}{letter}", *CHAIN_SOURCE), st)
               for (stage, letter), st in zip(chain_keys, chain_stats)]
            + [((name, HEAD_SOURCES[name[:2]], HEAD_REPLACES), st)
               for name, st in heads.items()]):
        rows.append({"name": name, "source": source, "replaces": replaces,
                     **decided(st)})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--images", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain path, every reading 0)")
    args = ap.parse_args(argv)

    from maskrcnn_tpu_torch.core.config import MaskRCNNConfig
    from maskrcnn_tpu_torch.models.mask_rcnn import resolve_device
    from maskrcnn_tpu_torch.pipeline.detector import MaskRCNNDetector
    from maskrcnn_tpu_torch.tools import flagship_proof as fp
    from maskrcnn_tpu_torch.tools.proof_numerics import _proof_seed

    device = resolve_device(args.device)   # raises without a card
    root = os.path.abspath(args.root)
    cfg = MaskRCNNConfig.from_json(os.path.join(root,
                                                "config_production.json"))
    detector = MaskRCNNDetector.from_checkpoint(
        cfg, os.path.join(root, "checkpoint.npz"), device=device)
    t0 = time.time()
    rows = run_audit(detector, val_batches(root, cfg.image_height,
                                           args.images, args.batch))
    report = {"device": fp.device_line(device), "seed": _proof_seed(root),
              "images": args.images, "batch": args.batch,
              "tf32_in_forward": {
                  "cudnn": torch.backends.cudnn.allow_tf32,
                  "matmul": torch.backends.cuda.matmul.allow_tf32},
              "tf32_in_audit": False,
              "rule": RULE, "rows": rows,
              "unbiased": all(r["rule"]["unbiased"] for r in rows),
              "seconds": round(time.time() - t0, 1)}
    for r in rows:
        kp = r["kernel_minus_plain"]
        print(f"# {r['name']}: kernel - plain {kp['mean_ulp']:+.3e} ulp "
              f"(se {kp['se_ulp']:.1e}), |err| kernel / plain "
              f"{r['rule']['abs_ratio']:.3f}, unbiased "
              f"{r['rule']['unbiased']}", file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
