"""The card route of ViTDet's biased attention against its alternatives,
on one NVIDIA card, at `vitdet_b.batch8`'s shapes (8 images at 1024^2:
global blocks (8, 12, 4096, 64) with 127-row tables, windowed blocks
(200, 12, 196, 64) with 27-row tables):

    python3 -m maskrcnn_tpu_torch.tools.probe_attention [--batch 8]

Routes, all bfloat16 in and out:
  augmented        `ops/attention.py`'s card route: SDPA on q' = [scale q,
                   rel_h, rel_w], k' = [k, onehots], the default backend
  augmented_<be>   the same under one SDPA backend (flash takes v padded
                   to q''s width and the output cut back)
  mask_<be>        the bias built as a (n, heads, T, T) bfloat16 tensor
                   per call and passed as SDPA's additive mask
  explicit         logits, bias and softmax in float32 from bfloat16
                   matmuls, no SDPA
For each: device ms a call (CUDA events over 20 calls after 3), the peak
memory above the inputs, and the largest and mean error against the
float32 plain route (`ops/attention.py::_plain`) over the largest
reference value. A route a backend refuses reads its error. Prints JSON
lines, the card's name and power limit last; needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from maskrcnn_tpu_torch.ops import attention as A

BACKENDS = {"flash": SDPBackend.FLASH_ATTENTION,
            "efficient": SDPBackend.EFFICIENT_ATTENTION,
            "cudnn": SDPBackend.CUDNN_ATTENTION}


def _augmented_flash(q, k, v, th, tw, hw, scale):
    width = A.round_up(q.shape[-1] + hw[0] + hw[1], 8)
    vp = F.pad(v, (0, width - v.shape[-1]))
    with sdpa_kernel(BACKENDS["flash"]):
        return A._card(q, k, vp, th, tw, hw, scale)[..., :v.shape[-1]]


def _mask(q, k, v, th, tw, hw, scale):
    h, w = hw
    n, heads, t, _ = q.shape
    rel_h, rel_w = A.decomposed_bias(q, th, tw, hw)
    bias = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(n, heads, t,
                                                               t)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                          scale=scale)


def _explicit(q, k, v, th, tw, hw, scale):
    h, w = hw
    n, heads, t, _ = q.shape
    rel_h, rel_w = A.decomposed_bias(q, th, tw, hw)
    logits = ((q * scale) @ k.transpose(-2, -1)).float()
    logits = (logits.view(n, heads, h, w, h, w) + rel_h[..., :, None].float()
              + rel_w[..., None, :].float()).view(n, heads, t, t)
    return torch.softmax(logits, -1).to(v.dtype) @ v


def _under(backend, fn):
    def run(*args):
        with sdpa_kernel(BACKENDS[backend]):
            return fn(*args)
    return run


def routes() -> dict:
    out = {"augmented": A._card, "augmented_flash": _augmented_flash}
    for be in ("efficient", "cudnn"):
        out["augmented_" + be] = _under(be, A._card)
        out["mask_" + be] = _under(be, _mask)
    out["mask_default"] = _mask
    out["explicit"] = _explicit
    return out


def case(n, grid, rows, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    t = grid * grid

    def r(*shape, s=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * s)

    # q, k at the spread the benchmark's weights give (logit std ~1)
    q, k, v = (r(n, 12, t, 64, s=1.0) for _ in range(3))
    th, tw = (torch.rand((rows, 64), generator=g, device="cuda") * 0.3
              - 0.15 for _ in range(2))
    return q, k, v, th, tw, (grid, grid)


def time_ms(fn, args, iters=20):
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn(*args)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_attention needs a CUDA device", file=sys.stderr)
        return 2
    shapes = {"global": (args.batch, 64, 127),
              "window": (args.batch * 25, 14, 27)}
    for block, (n, grid, rows) in shapes.items():
        q, k, v, th, tw, hw = case(n, grid, rows)
        scale = 64 ** -0.5
        ref = torch.cat([A._plain(q[i:i + 1], k[i:i + 1], v[i:i + 1], th, tw,
                                  hw, scale) for i in range(n)])
        big = float(ref.abs().max())
        bf = [x.to(torch.bfloat16) for x in (q, k, v)]
        for name, fn in routes().items():
            row = {"block": block, "route": name, "n": n, "tokens": grid ** 2}
            try:
                call = (*bf, th, tw, hw, scale)
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                got = fn(*call)
                peak = torch.cuda.max_memory_allocated() - base
                err = (got.float() - ref).abs()
                row.update(max_err=float(err.max()) / big,
                           mean_err=float(err.mean()) / big,
                           ms=time_ms(fn, call), peak_mib=peak / 2 ** 20)
                del got, err
            except RuntimeError as e:
                row["error"] = str(e).splitlines()[0][:200]
            print(json.dumps(row), flush=True)
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
