"""Native (C++) host-side data-path ops, bound via ctypes.

Copy of the JAX package's ``native/`` (same source, same bindings, same
fallbacks): the exact EDT and edge band, PIL-matching nearest and
antialiased-bilinear resizes (the latter fused with ImageNet
normalization), and the fused PIL ImageEnhance chain.  These run on the
host beside the card; they are not device kernels.

Compiled lazily with g++ on first use (cached by source hash under
``vivim_tpu_torch/native/_build/``); every entry point has a pure-Python
fallback, so the package works without a toolchain.  Disable with
``VIVIM_NATIVE=0``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "edge_ops.cc")
_LIB = None
_TRIED = False


def _build_lib():
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    build_dir = os.path.join(_DIR, "_build")
    os.makedirs(build_dir, exist_ok=True)
    so_path = os.path.join(build_dir, f"edge_ops_{digest}.so")
    if not os.path.exists(so_path):
        tmp = f"{so_path}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC,
             "-o", tmp],
            check=True, capture_output=True)
        os.replace(tmp, so_path)
    return so_path


def get_lib():
    """ctypes handle to the native library, or None if unavailable."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("VIVIM_NATIVE", "1") == "0":
        return None
    try:
        lib = ctypes.CDLL(_build_lib())
    except Exception as e:  # toolchain missing — fall back to python
        print(f"[vivim_tpu_torch.native] build failed ({e}); using python "
              "fallbacks")
        return None
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i = ctypes.c_int
    f = ctypes.c_float
    lib.vivim_edt.argtypes = [u8p, f32p, i, i]
    lib.vivim_edge_band.argtypes = [u8p, i, i, i, f, u8p]
    lib.vivim_resize_nearest_u8.argtypes = [u8p, i, i, u8p, i, i]
    lib.vivim_resize_bilinear_normalize.argtypes = [
        u8p, i, i, f32p, i, i, f32p, f32p]
    lib.vivim_color_enhance.argtypes = [u8p, i, i, f, f, f, f]
    for fn in (lib.vivim_edt, lib.vivim_edge_band, lib.vivim_resize_nearest_u8,
               lib.vivim_resize_bilinear_normalize, lib.vivim_color_enhance):
        fn.restype = None
    _LIB = lib
    return _LIB


def edt(mask: np.ndarray) -> np.ndarray:
    """Euclidean distance to the nearest zero pixel (scipy semantics)."""
    lib = get_lib()
    mask = np.ascontiguousarray(mask, np.uint8)
    if lib is None:
        from scipy.ndimage import distance_transform_edt

        return distance_transform_edt(mask).astype(np.float32)
    out = np.empty(mask.shape, np.float32)
    lib.vivim_edt(mask, out, mask.shape[0], mask.shape[1])
    return out


def edge_band(masks: np.ndarray, radius: float = 2.0) -> np.ndarray:
    """(C, H, W) binary masks -> (H, W) uint8 edge-band counts
    (Multiclass_Data.py:220-234 semantics, zero-padded by one pixel)."""
    lib = get_lib()
    masks = np.ascontiguousarray(masks, np.uint8)
    c, h, w = masks.shape
    if lib is None:
        from scipy.ndimage import distance_transform_edt

        emap = np.zeros((h, w), np.uint8)
        for ci in range(c):
            m = np.pad(masks[ci], 1)
            dist = distance_transform_edt(m) + distance_transform_edt(1 - m)
            emap += (dist[1:-1, 1:-1] <= radius).astype(np.uint8)
        return emap
    out = np.empty((h, w), np.uint8)
    lib.vivim_edge_band(masks, c, h, w, radius, out)
    return out


def resize_nearest(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """(H, W) uint8 nearest resize (PIL NEAREST pixel centers)."""
    lib = get_lib()
    img = np.ascontiguousarray(img, np.uint8)
    if lib is None:
        from PIL import Image

        return np.asarray(
            Image.fromarray(img).resize((dw, dh), Image.NEAREST))
    out = np.empty((dh, dw), np.uint8)
    lib.vivim_resize_nearest_u8(img, img.shape[0], img.shape[1], out, dh, dw)
    return out


def color_enhance(img: np.ndarray, f_bright: float, f_contrast: float,
                  f_color: float, f_sharp: float) -> np.ndarray:
    """Fused PIL ImageEnhance Brightness->Contrast->Color->Sharpness chain
    on an (H, W, 3) uint8 RGB array (ImageEnhance.py semantics; the four
    separate PIL passes are the host loader's largest cost).  Returns None
    when the native lib is unavailable (caller falls back to PIL)."""
    lib = get_lib()
    if lib is None:
        return None
    if img.ndim != 3 or img.shape[2] != 3:
        return None  # C++ writes h*w*3 bytes unconditionally; let PIL handle it
    img = np.ascontiguousarray(img, np.uint8)
    lib.vivim_color_enhance(img, img.shape[0], img.shape[1],
                            f_bright, f_contrast, f_color, f_sharp)
    return img


def resize_bilinear_normalize(img: np.ndarray, dh: int, dw: int,
                              mean, std) -> np.ndarray:
    """(H, W, 3) uint8 -> (dh, dw, 3) float32, bilinear + ImageNet norm."""
    lib = get_lib()
    img = np.ascontiguousarray(img, np.uint8)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    if lib is None:
        from PIL import Image

        r = np.asarray(Image.fromarray(img).resize((dw, dh), Image.BILINEAR),
                       np.float32) / 255.0
        return ((r - mean) / std).astype(np.float32)
    out = np.empty((dh, dw, 3), np.float32)
    lib.vivim_resize_bilinear_normalize(
        img, img.shape[0], img.shape[1], out, dh, dw, mean, std)
    return out
