"""The card routes of the port's biased attention against their
alternatives, on one NVIDIA card, at the benchmark cells' shapes:

    python3 -m maskrcnn_tpu_torch.tools.probe_attention [--batch 8]
        [--model vitdet swin]

ViTDet (`vitdet_b.batch8`, 8 images at 1024^2: global blocks (8, 12,
4096, 64) with 127-row tables, windowed blocks (200, 12, 196, 64) with
27-row tables). Routes, all bfloat16 in and out:
  augmented        `ops/attention.py`'s card route: SDPA on q' = [scale q,
                   rel_h, rel_w], k' = [k, onehots], the default backend
  augmented_<be>   the same under one SDPA backend (flash takes v padded
                   to q''s width and the output cut back)
  mask_<be>        the bias built as a (n, heads, T, T) bfloat16 tensor
                   per call and passed as SDPA's additive mask
  explicit         logits, bias and softmax in float32 from bfloat16
                   matmuls, no SDPA

Swin (`swin_s.batch8`, 8 images at 1024^2: stage 1's 1369 windows of 49
tokens an image, 3 heads of 32; stage 3's 100 windows, 12 heads), each in
a plain and a shifted block, q, k, v the strided views of qkv the model
hands over. Routes:
  folded           `ops/attention.py`'s card route: one SDPA call on the
                   memory-efficient kernel, the bias (and the shifted
                   block's region mask) folded into one cached additive
                   mask broadcast over the images
  folded_<be>      the same on SDPA's default choice or on cuDNN
  folded_full      a shifted block's mask materialised for every image's
                   windows (cached, its rows padded to 64 columns), q, k,
                   v left as views, the memory-efficient kernel
  augmented        SDPA on q' = [scale q, onehot(query)], k' = [k,
                   bias + mask], 88 wide
  explicit         as above

For each: device ms a call (CUDA events over 20 calls after 3), the peak
memory above the inputs, and the largest and mean error against the
float32 plain route (`ops/attention.py::_plain`, `_window_plain`) over
the largest reference value. A route a backend refuses reads its error.
Prints JSON lines, the card's name and power limit last; needs a card.
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
from maskrcnn_tpu_torch.ops.common import round_up, shift_regions

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


# --------------------------------------------------------------------------
# Swin's windows
# --------------------------------------------------------------------------

_built: dict = {}


def _once(key, build):
    """A route's constants, built at its first call (outside the timing),
    as the model's card route caches its mask."""
    if key not in _built:
        _built[key] = build()
    return _built[key]


def _swin_full(q, k, v, table, window, scale, regions):
    b, nw, heads, t, d = q.shape

    def build():
        mask = A._folded_mask(table, window, regions, q.dtype)
        store = mask.new_zeros((b * nw, heads, t, round_up(t, 64)))
        store.view(b, nw, heads, t, -1)[..., :t] = mask.view(1, nw, heads,
                                                             t, t)
        return store[..., :t]
    mask = _once(("full", id(table), b), build)
    rows = (b * nw, heads)
    return F.scaled_dot_product_attention(
        q.reshape(*rows, t, d), k.reshape(*rows, t, d),
        v.reshape(*rows, t, d), attn_mask=mask, scale=scale).view(q.shape)


def _swin_augmented(q, k, v, table, window, scale, regions):
    b, nw, heads, t, d = q.shape
    width = round_up(d + t, 8) - d

    def build():
        bias = A.window_bias(table.float(), window)          # (heads, T, T)
        if regions is not None:
            bias = bias[None] + A.region_mask(regions)[:, None]
        else:
            bias = bias[None].expand(nw, -1, -1, -1)
        keys = F.pad(bias.transpose(-1, -2), (0, width - t)).to(q.dtype)
        onehot = F.pad(torch.eye(t, device=q.device, dtype=q.dtype),
                       (0, width - t))
        return keys, onehot
    keys, onehot = _once(("augmented", id(table)), build)
    qa = torch.cat([q * scale, onehot.expand(b, nw, heads, t, width)], -1)
    ka = torch.cat([k, keys.expand(b, -1, -1, -1, -1)], -1)
    n = b * nw
    return F.scaled_dot_product_attention(
        qa.reshape(n, heads, t, d + width), ka.reshape(n, heads, t,
                                                       d + width),
        v.reshape(n, heads, t, d), scale=1.0).view(q.shape)


def _swin_explicit(q, k, v, table, window, scale, regions):
    logits = ((q * scale) @ k.transpose(-2, -1)).float()
    logits = logits + A.window_bias(table.float(), window)
    if regions is not None:
        logits = logits + A.region_mask(regions)[:, None]
    return torch.softmax(logits, -1).to(v.dtype) @ v


def swin_routes() -> dict:
    out = {"folded": A._window_card, "folded_default": A._window_sdpa,
           "folded_cudnn": _under("cudnn", A._window_sdpa),
           "folded_full": _under("efficient", _swin_full)}
    out["augmented"] = _swin_augmented
    out["explicit"] = _swin_explicit
    return out


def swin_case(b, grid, heads, shifted, seed=0):
    """q, k, v as the strided views of a (b, windows, T, 3, heads, 32)
    qkv, a table uniform in +-1.5 (the benchmark's), and the regions of a
    shifted block."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    window, d = 7, 32
    padded = (round_up(grid, window),) * 2
    nw = (padded[0] // window) ** 2
    qkv = torch.randn((b, nw, window * window, 3, heads, d), generator=g,
                      device="cuda").to(torch.bfloat16)
    q, k, v = qkv.permute(3, 0, 1, 4, 2, 5).unbind(0)
    table = torch.rand(((2 * window - 1) ** 2, heads), generator=g,
                       device="cuda") * 3.0 - 1.5
    regions = (shift_regions(padded, window, window // 2,
                             torch.device("cuda")) if shifted else None)
    return q, k, v, table, window, d ** -0.5, regions


def probe_swin(batch: int) -> None:
    shapes = {"stage1": (256, 3), "stage3": (64, 12)}
    for stage, (grid, heads) in shapes.items():
        for shifted in (False, True):
            _built.clear()
            case_ = swin_case(batch, grid, heads, shifted)
            q, k, v, table, window, scale, regions = case_
            ref = torch.cat([A._window_plain(
                q[i:i + 1], k[i:i + 1], v[i:i + 1], table, window, scale,
                regions) for i in range(batch)])
            big = float(ref.abs().max())
            for name, fn in swin_routes().items():
                if name == "folded_full" and not shifted:
                    continue
                row = {"model": "swin", "stage": stage, "shifted": shifted,
                       "route": name, "shape": list(q.shape)}
                try:
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                    got = fn(*case_)
                    peak = torch.cuda.max_memory_allocated() - base
                    err = (got.float() - ref).abs()
                    row.update(max_err=float(err.max()) / big,
                               mean_err=float(err.mean()) / big,
                               ms=time_ms(fn, case_), peak_mib=peak / 2 ** 20)
                    del got, err
                except RuntimeError as e:
                    row["error"] = str(e).splitlines()[0][:200]
                print(json.dumps(row), flush=True)
                torch.cuda.empty_cache()
            del ref, case_, q, k, v
            torch.cuda.empty_cache()


def probe_vitdet(batch: int) -> None:
    shapes = {"global": (batch, 64, 127),
              "window": (batch * 25, 14, 27)}
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--model", nargs="+", choices=("vitdet", "swin"),
                    default=["vitdet", "swin"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_attention needs a CUDA device", file=sys.stderr)
        return 2
    if "vitdet" in args.model:
        probe_vitdet(args.batch)
    if "swin" in args.model:
        probe_swin(args.batch)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
