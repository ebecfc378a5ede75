"""Native (C++) host components, loaded via ctypes: the port's own copy of
`maskrcnn_tpu/native` (same sources, bindings and g++ flags, so both
packages compute the same bits on one machine).

Build is lazy and cached: the first use compiles `src/<name>.cpp` with g++
into `maskrcnn_tpu_torch/build/lib<name>-<hash>.so`, the hash taken over the
source bytes, the flags and the host CPU's feature flags (a few seconds,
once; an edited source or another CPU gets a new file). Each process
compiles to a file of its own and renames it into place, so processes that
build together leave one whole library. A library that fails to build or
load gives `None` to its getter, the callers take their PIL/numpy
fallback, and `native_errors()` says why. Where libjpeg's header is
missing, libimageio is built without its JPEG entry points (`-DMRT_NO_JPEG`,
`lib.has_jpeg` False): letterbox and paste stay native and the loader
decodes with PIL.

Libraries:
  * librle       — COCO RLE mask codec + IoU matrices (evalkit backend).
  * libimageio   — JPEG decode (libjpeg), letterbox resize and mask paste
                   (loader and detector).
  * libevalmatch — COCO greedy dt<->gt matching core (evalkit backend).

ctypes releases the interpreter lock for the length of each call, so the
loader's prefetch threads and the server's handler threads run these in
parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_HERE = os.path.dirname(__file__)
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")

_lock = threading.Lock()
_libs: dict[str, object] = {}
_errors: dict[str, str] = {}

i64 = ctypes.c_int64
u64 = ctypes.c_uint64
p_u8 = ctypes.POINTER(ctypes.c_uint8)
p_u32 = ctypes.POINTER(ctypes.c_uint32)
p_i64 = ctypes.POINTER(ctypes.c_int64)
p_f32 = ctypes.POINTER(ctypes.c_float)
p_f64 = ctypes.POINTER(ctypes.c_double)


def _cpu_tag() -> tuple[str, bool]:
    """(cache-key component, precise) tied to the host's ISA: builds use
    -march=native, so an .so cached on one machine must not be dlopen'd on
    a CPU lacking those extensions (SIGILL). `precise=False` means the real
    feature flags could not be read: the build is then generic."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return hashlib.sha1(line.encode()).hexdigest()[:8], True
    except OSError:
        pass
    import platform

    return hashlib.sha1(platform.machine().encode()).hexdigest()[:8], False


def _so_path(src: str, flags: list[str], tag: str) -> str:
    """The library's path: its name hashes the source bytes, the flags and
    the CPU tag (file times do not survive a checkout or an archive)."""
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(repr((flags, tag)).encode())
    name = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(_BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _compile(src: str, so: str, link_flags: list[str], precise: bool) -> None:
    """g++ into a file of this process's own, then rename it into place."""
    tmp = f"{so}.{os.getpid()}.tmp"
    base = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp]
    try:
        # vectorize for the build host ONLY when the cache key reflects
        # real feature flags; an arch-only tag can't distinguish ISA
        # levels, so build generic there
        if not precise:
            raise subprocess.CalledProcessError(1, "generic")
        subprocess.run(base[:1] + ["-march=native"] + base[1:] + link_flags,
                       check=True, capture_output=True, text=True)
    except subprocess.CalledProcessError:
        try:
            subprocess.run(base + link_flags, check=True,
                           capture_output=True, text=True)
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"g++ failed (rc {e.returncode}):\n"
                               f"{e.stderr}") from None
    os.replace(tmp, so)


def _open(name: str, flags: list[str]):
    """Build `src/<name>.cpp` with `flags` (if not built yet) and dlopen it."""
    src = os.path.join(_HERE, "src", f"{name}.cpp")
    tag, precise = _cpu_tag()
    so = _so_path(src, flags + ["-march=native"] * precise, tag)
    if not os.path.exists(so):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        _compile(src, so, flags, precise)
    return ctypes.CDLL(so)


def _load(name: str, flag_sets: list[list[str]], bind) -> object | None:
    """Build (if absent) + dlopen + bind signatures, trying each flag set
    in turn; None when every one fails. Each failure's reason stays in
    `native_errors()`: under `name`, or under "<name> <flags>" for a flag
    set that a later one stood in for."""
    with _lock:
        if name in _libs:
            return _libs[name]
        if name in _errors:
            return None
        failed = []
        for flags in flag_sets:
            try:
                lib = _open(name, flags)
                bind(lib)
            except Exception as e:  # missing g++/headers, bad cache, ...
                failed.append((flags, f"{type(e).__name__}: {e}"))
                continue
            for f, reason in failed:
                _errors[" ".join([name, *f])] = reason
            _libs[name] = lib
            return lib
        _errors[name] = "\n".join(reason for _, reason in failed)
        return None


def _bind_rle(lib) -> None:
    lib.rle_encode.restype = i64
    lib.rle_encode.argtypes = [p_u8, i64, i64, p_u32]
    lib.rle_encode_rowmajor.restype = i64
    lib.rle_encode_rowmajor.argtypes = [p_u8, i64, i64, p_u32]
    lib.rle_decode.restype = None
    lib.rle_decode.argtypes = [p_u32, i64, i64, i64, p_u8]
    lib.rle_area.restype = u64
    lib.rle_area.argtypes = [p_u32, i64]
    lib.rle_intersection.restype = u64
    lib.rle_intersection.argtypes = [p_u32, i64, p_u32, i64]
    lib.rle_iou_matrix.restype = None
    lib.rle_iou_matrix.argtypes = [p_u32, p_i64, p_i64, i64,
                                   p_u32, p_i64, p_i64, i64, p_u8, p_f64]
    lib.bbox_iou_matrix.restype = None
    lib.bbox_iou_matrix.argtypes = [p_f64, i64, p_f64, i64, p_u8, p_f64]
    lib.poly_rasterize.restype = None
    lib.poly_rasterize.argtypes = [p_f64, i64, i64, i64, p_u8]


def _bind_imageio(lib) -> None:
    f64 = ctypes.c_double
    lib.img_letterbox_rgb8.restype = ctypes.c_int
    lib.img_letterbox_rgb8.argtypes = [p_u8, i64, i64, i64, p_f32, p_f64]
    lib.img_paste_mask.restype = ctypes.c_int
    lib.img_paste_mask.argtypes = [p_f32, i64, f64, f64, f64, f64,
                                   i64, i64, f64, p_u8]
    lib.img_paste_mask_region.restype = ctypes.c_int
    lib.img_paste_mask_region.argtypes = [p_f32, i64, f64, f64, f64, f64,
                                          i64, i64, f64, p_u8, i64]
    lib.has_jpeg = hasattr(lib, "img_jpeg_dims")  # False: -DMRT_NO_JPEG
    if not lib.has_jpeg:
        return
    c_char_p = ctypes.c_char_p
    lib.img_jpeg_dims.restype = ctypes.c_int
    lib.img_jpeg_dims.argtypes = [c_char_p, p_i64]
    lib.img_decode_jpeg.restype = ctypes.c_int
    lib.img_decode_jpeg.argtypes = [c_char_p, p_u8, i64, p_i64]
    lib.img_decode_letterbox_jpeg.restype = ctypes.c_int
    lib.img_decode_letterbox_jpeg.argtypes = [c_char_p, i64, p_f32, p_f64]
    lib.img_jpeg_dims_mem.restype = ctypes.c_int
    lib.img_jpeg_dims_mem.argtypes = [p_u8, i64, p_i64]
    lib.img_decode_jpeg_mem.restype = ctypes.c_int
    lib.img_decode_jpeg_mem.argtypes = [p_u8, i64, p_u8, i64, p_i64]
    lib.img_decode_letterbox_jpeg_mem.restype = ctypes.c_int
    lib.img_decode_letterbox_jpeg_mem.argtypes = [p_u8, i64, i64, p_f32,
                                                  p_f64]


def _bind_evalmatch(lib) -> None:
    lib.eval_match.restype = None
    lib.eval_match.argtypes = [p_f64, i64, i64, p_u8, p_u8, p_u8, i64,
                               p_f64, i64, p_i64, p_u8, p_i64]


def get_evalmatch_lib():
    """The compiled libevalmatch (COCO greedy matching core), or None."""
    return _load("evalmatch", [[]], _bind_evalmatch)


def get_rle_lib():
    """The compiled librle, or None if the toolchain is unavailable."""
    return _load("rle", [[]], _bind_rle)


def get_imageio_lib():
    """The compiled libimageio, or None (no toolchain). Without libjpeg's
    header it has no JPEG entry points: `has_jpeg` is False."""
    return _load("imageio", [["-ljpeg"], ["-DMRT_NO_JPEG"]], _bind_imageio)


def native_available() -> bool:
    return get_rle_lib() is not None


def native_errors() -> dict[str, str]:
    """Why each library that failed to build or load did so, by name
    ("rle", "imageio", "evalmatch"), and why libimageio was built without
    libjpeg ("imageio -ljpeg"); empty while nothing has failed."""
    with _lock:
        return dict(_errors)
