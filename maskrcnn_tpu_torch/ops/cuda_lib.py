"""Build and load the port's CUDA kernels (`csrc/*.cu`) at first use.

Each source compiles to an object with its own `nvcc` process, all started
together, and the objects link into one shared library with a plain C
interface, loaded with ctypes (no PyTorch headers: the build takes seconds).
Target is `sm_90a` (Hopper). The library lands in `maskrcnn_tpu_torch/build/`
under a name that hashes the sources and flags, so an edited source is
rebuilt. A failed build raises; there is no fallback.

`launches` counts kernel launches per kernel family. Each wrapper adds one
where it launches its kernel and nowhere else, so a caller can zero the
counts, run the main path, and see which kernels it went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD = os.path.join(os.path.dirname(os.path.dirname(__file__)), "build")
SOURCES = ("nms.cu", "roi_align.cu", "stem.cu", "bottleneck.cu")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
COMMON_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo")
# Per-source extra flags. NMS must equal the sequential greedy bit for bit:
# no FMA contraction in its IoU test (the source also spells it with
# __fmul_rn / __fadd_rn, this is the second guard).
EXTRA_FLAGS = {"nms.cu": ("-fmad=false",)}

launches = {"nms": 0, "roi_align": 0, "stem": 0, "bottleneck": 0}

_lib = None
_lock = threading.Lock()


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    h.update(repr((ARCH, COMMON_FLAGS, EXTRA_FLAGS)).encode())
    return h.hexdigest()[:16]


def _build(lib_path: str, verbose: bool) -> None:
    nvcc = _nvcc()
    objdir = lib_path + ".objs"
    os.makedirs(objdir, exist_ok=True)
    procs = []
    for name in SOURCES:
        obj = os.path.join(objdir, name.replace(".cu", ".o"))
        cmd = [nvcc, ARCH, *COMMON_FLAGS, *EXTRA_FLAGS.get(name, ()),
               "-c", os.path.join(CSRC, name), "-o", obj]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    objs, errors = [], []
    for name, obj, proc in procs:
        out, _ = proc.communicate()
        text = out.decode(errors="replace")
        if proc.returncode != 0:
            errors.append(f"--- nvcc {name} (rc {proc.returncode}):\n{text}")
        elif verbose and text.strip():
            print(f"--- nvcc {name}:\n{text}", flush=True)
        objs.append(obj)
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    link = subprocess.run([nvcc, ARCH, "-shared", "-o", tmp, *objs],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"CUDA kernel link failed:\n{link.stdout}"
                           f"{link.stderr}")
    os.replace(tmp, lib_path)


def _declare(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sig = {
        "mrt_nms_keep": [p, p, p, i, i, f, i, i, p],
        "mrt_nms_max_boxes": [i],
        "mrt_roi_align": [p, p, p, p, i, i, i, i, i, i, i, i, i,
                          p, p, p, p, i, i, i, i, p, p],
        "mrt_stem": [p, p, p, p, i, i, i, p],
        "mrt_bottleneck": [p, p, p, p, p, p, p, p, p, p,
                           i, i, i, i, i, i, i, p],
    }
    for name, argtypes in sig.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int


def load(verbose: bool = False):
    """The loaded kernel library, building it on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        os.makedirs(BUILD, exist_ok=True)
        lib_path = os.path.join(BUILD, f"libmrt_kernels_{_digest()}.so")
        if not os.path.exists(lib_path):
            _build(lib_path, verbose)
        lib = ctypes.CDLL(lib_path)
        _declare(lib)
        _lib = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch function."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"cudaError {rc}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple | None = None) -> None:
    """Validate a tensor before its pointer goes to a kernel."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
