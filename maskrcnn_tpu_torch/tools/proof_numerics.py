"""Where the flagship proof's production - exact AP delta comes from: one
trained checkpoint scored under numerics that differ by one knob each.

    python3 -m maskrcnn_tpu_torch.tools.proof_numerics --root DIR \\
        [--out FILE] [--device cpu]

`--root` is a root that `tools/flagship_proof.py` has trained in
(`checkpoint.npz`, `config_production.json`, its synthetic COCO set: run
the proof with `--val-images 320` for a larger val set). The report's
`seed` is the proof's, read from its report at the default path
`<root>/flagship_proof.json` (null where that file is absent). The variants,
each `cli evaluate` over every val image of that set at the proof's
evaluate batch of 8:

  production         bf16, analytic anchors, K3/K4 in the backbone
  production_layers  the same with K3 and K4 off: the backbone's plain
                     bf16 layers (cuDNN), the path training ran
  production_plain_k3k4  K3's and K4's plain versions in their place
                     (the same folded-BN bf16 math on the card): sets
                     the kernels apart from the folding
  bf16_table_anchors production with the anchor table (the exact run's)
  exact_fp32         float32, exact top-k, table anchors, TF32 off
  exact_tf32         the same with TF32 on (PyTorch's cuDNN default)
  production_fused_heads  production with both fused heads on
                     (`fuse_classifier_head`, `fuse_mask_head`): K5 and
                     K6 on the card
  production_plain_heads  the same config with K5's and K6's plain
                     versions in their place (the names `roi_align` calls
                     them by): sets the kernels apart from the folding

Each is scored over the first 64 val images (the proof's own val set at
its defaults: a dataset redrawn with more val images keeps those first)
and over all of them, with each variant's cross-mode deltas against
`exact_fp32`. The port's top-k is always exact, so `proposal_topk_recall`
plays no part. Prints one JSON object last.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

from maskrcnn_tpu_torch.tools import flagship_proof as fp

VARIANTS = ("production", "production_layers", "production_plain_k3k4",
            "bf16_table_anchors", "exact_fp32", "exact_tf32",
            "production_fused_heads", "production_plain_heads")
PROOF_VAL_IMAGES = 64   # flagship_proof.py's default --val-images
EVAL_BATCH = 8          # and its default --eval-batch


@contextlib.contextmanager
def _patched(*subs):
    """Each (module, name, value) set for the run, then put back."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in subs]
    for mod, name, value in subs:
        setattr(mod, name, value)
    try:
        yield
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)


def fused_heads(cfg):
    """`cfg` with both ROI heads fused behind their pools (K5, K6)."""
    return cfg.replace(fuse_classifier_head=True, fuse_mask_head=True)


def _variant(name, base):
    """(config, context, TF32 off) of a variant over the production
    config."""
    from maskrcnn_tpu_torch.ops import bottleneck_cuda as k4, roi_align
    from maskrcnn_tpu_torch.ops import roi_align_cuda as rac, stem_cuda as k3

    exact = fp.exact_config(base)
    plain = contextlib.nullcontext
    no_k3k4 = _patched((k3, "stem_supported", lambda *a: False),
                       (k4, "chain_supported", lambda *a: False))
    plain_k3k4 = _patched(
        (k3, "stem", lambda im, w, b: k3.stem_plain(im.contiguous(), w, b)),
        (k4, "fused_bottleneck_chain", k4.chain_plain))
    plain_heads = _patched(
        (roi_align, "roi_classifier_head", rac.classifier_head_plain),
        (roi_align, "roi_mask_head", rac.mask_head_plain))
    return {"production": (base, plain(), False),
            "production_layers": (base, no_k3k4, False),
            "production_plain_k3k4": (base, plain_k3k4, False),
            "bf16_table_anchors": (base.replace(analytic_anchors=False),
                                   plain(), False),
            "exact_fp32": (exact, plain(), True),
            "exact_tf32": (exact, plain(), False),
            "production_fused_heads": (fused_heads(base), plain(), False),
            "production_plain_heads": (fused_heads(base), plain_heads,
                                       False)}[name]


def _proof_seed(root):
    """The seed the proof drew the root's dataset and training from."""
    path = os.path.join(root, "flagship_proof.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)["seed"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--out")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    from maskrcnn_tpu_torch.cli.main import main as cli
    from maskrcnn_tpu_torch.core.config import MaskRCNNConfig
    from maskrcnn_tpu_torch.models.mask_rcnn import resolve_device

    device = resolve_device(args.device)
    on = [] if args.device is None else ["--device", args.device]
    root = os.path.abspath(args.root)
    ann_dir = os.path.join(root, "data/coco")
    with open(os.path.join(ann_dir, "instances_val2017.json")) as f:
        n_val = len(json.load(f)["images"])
    ckpt = os.path.join(root, "checkpoint.npz")
    base = MaskRCNNConfig.from_json(os.path.join(root,
                                                 "config_production.json"))
    report = {"device": fp.device_line(device), "seed": _proof_seed(root),
              "val_images": n_val}
    results = {}
    for name in VARIANTS:
        cfg, ctx, exact = _variant(name, base)
        cfg_path = os.path.join(root, f"config_{name}.json")
        cfg.to_json(cfg_path)
        res_dir = os.path.join(root, f"numerics_{name}")
        t0 = time.time()
        with ctx:
            rc, launches, peak = fp.run_counted(cli, [
                "evaluate", "proof", "coco", "--limit", str(n_val),
                "--batch", str(EVAL_BATCH), "--config", cfg_path,
                "--weights", ckpt, "--annotations_dir", ann_dir,
                "--images_dir", os.path.join(ann_dir, "val2017"),
                "--results_dir", res_dir] + on, device, exact=exact)
        if rc != 0:
            print(f"evaluate ({name}) failed", file=sys.stderr)
            return rc
        results[name] = os.path.join(res_dir, "results.json")
        report[name] = {
            f"first_{PROOF_VAL_IMAGES}": fp.score(root, results[name],
                                                  PROOF_VAL_IMAGES),
            f"all_{n_val}": fp.score(root, results[name], n_val),
            "launches": launches, "peak_gb": peak,
            "seconds": round(time.time() - t0, 1)}
        print(f"# {name}: {report[name]}", file=sys.stderr)
    ref = results["exact_fp32"]
    report["deltas_vs_exact_fp32"] = {
        name: fp.cross_mode_deltas(root, {name: path, "exact_fp32": ref},
                                   n_val)
        for name, path in results.items() if name != "exact_fp32"}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
