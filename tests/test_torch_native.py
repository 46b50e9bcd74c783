"""The port's native host ops (``vivim_tpu_torch.native``) against the JAX
package's on the same seeded uint8 arrays: EDT, edge band, nearest resize,
bilinear resize with normalization and the fused colour enhance, through
the C++ library and through each package's Python fallback (``_LIB=None,
_TRIED=True``, as tests/test_data.py forces it).  Every output is equal
exactly, float32 ones included."""

import hashlib
import os
import shutil
import subprocess

import numpy as np
import pytest

from vivim_tpu import native as jnative
from vivim_tpu.data.augment import IMAGENET_MEAN, IMAGENET_STD
from vivim_tpu_torch import native


def jax_native_lib():
    """The JAX package's native library, compiled first under a
    process-unique temporary name: its own build writes one fixed
    temporary path, which test workers building at once would share."""
    with open(jnative._SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(jnative._DIR, "_build", f"edge_ops_{digest}.so")
    if not os.path.exists(so) and shutil.which("g++"):
        os.makedirs(os.path.dirname(so), exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC",
                        jnative._SRC, "-o", tmp],
                       check=True, capture_output=True)
        os.replace(tmp, so)
    return jnative.get_lib()


def _mask(seed, shape, p=0.6):
    return (np.random.default_rng(seed).random(shape) > p).astype(np.uint8)


def _image(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


# op name -> (function of a native module, list of argument tuples)
CASES = {
    "edt": (lambda m, a: m.edt(a[0]),
            [(_mask(0, (33, 57)),), (_mask(1, (64, 64)),)]),
    "edge_band_windowed": (lambda m, a: m.edge_band(a[0], 2.0),
                           [(_mask(2, (3, 40, 40), 0.7),),
                            (_mask(3, (1, 17, 29), 0.5),)]),
    "edge_band_edt": (lambda m, a: m.edge_band(a[0], 5.0),
                      [(_mask(4, (3, 40, 40), 0.7),)]),
    "resize_nearest": (lambda m, a: m.resize_nearest(a[0], *a[1]),
                       [(_image(5, (37, 53)), (16, 16)),
                        (_image(6, (20, 30)), (41, 33))]),
    "resize_bilinear_normalize": (
        lambda m, a: m.resize_bilinear_normalize(
            a[0], *a[1], IMAGENET_MEAN, IMAGENET_STD),
        [(_image(7, (64, 80, 3)), (32, 32)),
         (_image(8, (96, 96, 3)), (64, 48)),
         (_image(9, (24, 24, 3)), (40, 40))]),
    # the op writes into its input: each package gets its own copy
    "color_enhance": (lambda m, a: m.color_enhance(a[0].copy(), *a[1]),
                      [(_image(10, (48, 40, 3)), (1.2, 0.8, 1.1, 0.7)),
                       (_image(11, (31, 17, 3)), (0.5, 1.5, 0.9, 1.3))]),
}


@pytest.fixture(params=["library", "fallback"])
def backend(request, monkeypatch):
    if request.param == "fallback":
        for mod in (native, jnative):
            monkeypatch.setattr(mod, "_LIB", None)
            monkeypatch.setattr(mod, "_TRIED", True)
    elif native.get_lib() is None or jax_native_lib() is None:
        pytest.skip("native library unavailable (no g++)")
    return request.param


@pytest.mark.parametrize("op", sorted(CASES))
def test_native_op_equals_jax(op, backend):
    fn, cases = CASES[op]
    for args in cases:
        got, want = fn(native, args), fn(jnative, args)
        if op == "color_enhance" and backend == "fallback":
            # no fused chain without the library: the caller uses PIL
            assert got is None and want is None
            continue
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=op)
