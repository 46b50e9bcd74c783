"""Selective scan, causal conv and the fused Mamba inner of the PyTorch port
against the JAX package.

The same numpy inputs, made from a seed, go through the port (on the CPU:
its plain PyTorch version) and through the JAX functions: ``selective_scan``
runs its Pallas kernel in interpret mode off-TPU, ``refs`` the sequential
reference.  Tolerances are the JAX suite's (tests/test_selective_scan.py):
fp32 rtol 6e-4 / atol 2e-3, bf16 rtol 3e-2 / atol 5e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vivim_tpu.kernels import refs as jrefs
from vivim_tpu.kernels.causal_conv1d import causal_conv1d as j_conv
from vivim_tpu.kernels.mamba_inner import mamba_inner_grouped as j_inner_g
from vivim_tpu.kernels.selective_scan import selective_scan as j_scan
from vivim_tpu_torch.kernels import _build
from vivim_tpu_torch.kernels import refs as trefs
from vivim_tpu_torch.kernels import selective_scan as tss
from vivim_tpu_torch.kernels.causal_conv1d import causal_conv1d
from vivim_tpu_torch.kernels.mamba_inner import mamba_inner_grouped

torch.set_num_threads(1)

TOL = {"float32": (6e-4, 2e-3), "bfloat16": (3e-2, 5e-2)}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, b, L, d, n=16, groups=0, per_batch=False, h0=False,
            has_z=True, has_D=True, has_bias=True):
    rng = np.random.default_rng(seed)
    bc = (b, L, groups, n) if groups else (b, L, n)
    pshape = (b, d) if per_batch else (d,)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(
        u=f(b, L, d), delta=0.5 * f(b, L, d),
        A=-(0.5 + rng.random(((b,) if per_batch else ()) + (d, n))
            ).astype(np.float32),
        B=f(*bc), C=f(*bc),
        D=f(*pshape) if has_D else None,
        z=f(b, L, d) if has_z else None,
        delta_bias=0.1 * f(*pshape) if has_bias else None,
        initial_state=f(b, d, n) if h0 else None)


def _to(x, fw, dtype):
    """numpy -> jax / torch; activations in ``dtype``, parameters fp32."""
    if x is None:
        return None
    if fw == "jax":
        return jnp.asarray(x, dtype)
    return torch.from_numpy(x).to(dtype)


def _call(fn, fw, inp, dtype, softplus, last):
    seq = ("u", "delta", "B", "C", "z")
    kw = {k: _to(v, fw, (_JDT if fw == "jax" else _TDT)[
        dtype if k in seq else "float32"]) for k, v in inp.items()}
    return fn(kw.pop("u"), kw.pop("delta"), kw.pop("A"), kw.pop("B"),
              kw.pop("C"), delta_softplus=softplus, return_last_state=last,
              **kw)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


CASES = {
    # name: (input kwargs, dtype, softplus, return_last_state)
    "b2_L200_d24": (dict(b=2, L=200, d=24), "float32", True, True),
    # two JAX d-tiles, ragged L, per-batch A/D/bias, initial + last state
    "b3_L333_d160_h0": (dict(b=3, L=333, d=160, per_batch=True, h0=True),
                        "float32", True, True),
    "no_z_D_bias_softplus": (dict(b=2, L=48, d=12, n=8, has_z=False,
                                  has_D=False, has_bias=False),
                             "float32", False, False),
    "grouped_bc": (dict(b=2, L=64, d=32, groups=2, h0=True), "float32",
                   True, True),
    "bf16": (dict(b=1, L=64, d=16), "bfloat16", True, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_selective_scan_matches_jax(case):
    kw, dtype, softplus, last = CASES[case]
    inp = _inputs(sorted(CASES).index(case), **kw)
    got = _call(tss.selective_scan, "torch", inp, dtype, softplus, last)
    want_pallas = _call(j_scan, "jax", inp, dtype, softplus, last)
    want_ref = _call(jrefs.selective_scan_ref, "jax", inp, dtype, softplus,
                     last)
    rtol, atol = TOL[dtype]
    pairs = (lambda o: list(o) if last else [o])
    for want in (want_pallas, want_ref):
        for g, w in zip(pairs(got), pairs(want)):
            assert tuple(g.shape) == tuple(w.shape)
            np.testing.assert_allclose(_np(g), _np(w), rtol=rtol, atol=atol)
    if dtype == "bfloat16":
        assert pairs(got)[0].dtype == torch.bfloat16


def test_port_refs_match_jax_refs_with_constant_bc():
    """Constant (dim, dstate) B and C in the plain versions."""
    rng = np.random.default_rng(5)
    inp = _inputs(5, b=2, L=40, d=8, n=4)
    inp["B"] = rng.standard_normal((8, 4)).astype(np.float32)
    inp["C"] = rng.standard_normal((8, 4)).astype(np.float32)
    got = _call(trefs.selective_scan_ref, "torch", inp, "float32", True, True)
    want = _call(jrefs.selective_scan_ref, "jax", inp, "float32", True, True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=6e-4, atol=2e-3)


def test_cpu_scan_is_differentiable_like_jax_ref():
    """On the CPU the plain version carries autograd: du and dA against
    jax.grad of the JAX reference (grad tolerance rtol 1e-3 / atol 2e-3)."""
    inp = _inputs(3, b=2, L=40, d=8, n=4)
    w = np.linspace(0, 1, 2 * 40 * 8, dtype=np.float32).reshape(2, 40, 8)

    def jloss(u, A):
        kw = {k: _to(v, "jax", jnp.float32) for k, v in inp.items()
              if k not in ("u", "A")}
        out = jrefs.selective_scan_ref(u, kw.pop("delta"), A, kw.pop("B"),
                                       kw.pop("C"), delta_softplus=True,
                                       **kw)
        return jnp.sum(out * w)

    gu, gA = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(inp["u"]),
                                             jnp.asarray(inp["A"]))
    t = {k: _to(v, "torch", torch.float32) for k, v in inp.items()}
    t["u"].requires_grad_(True)
    t["A"].requires_grad_(True)
    out = tss.selective_scan(t["u"], t["delta"],
                             t["A"], t["B"], t["C"], D=t["D"], z=t["z"],
                             delta_bias=t["delta_bias"], delta_softplus=True)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(t["u"].grad.numpy(), np.asarray(gu),
                               rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(t["A"].grad.numpy(), np.asarray(gA),
                               rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("activation", [None, "silu"])
def test_causal_conv1d_matches_jax(activation):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 37, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    got = causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(bias), activation)
    want = j_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                  activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    ref = trefs.causal_conv1d_ref(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(bias), activation)
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_mamba_inner_grouped_matches_jax():
    """Three directions x nb=2 through one scan, against the JAX grouped
    inner on its Pallas kernel (interpret mode)."""
    rng = np.random.default_rng(2)
    G, nb, L, d, n, rank, width = 3, 2, 30, 32, 16, 2, 4
    f = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(
        np.float32)
    args = dict(
        xz=f(G * nb, L, 2 * d), conv_w=f(G, width, d, scale=0.5),
        conv_b=f(G, d, scale=0.1), x_proj=f(G, rank + 2 * n, d, scale=0.2),
        dt_proj=f(G, d, rank, scale=0.5),
        A_log=np.log(np.tile(np.arange(1, n + 1, dtype=np.float32),
                             (G, d, 1))),
        D=f(G, d), dt_bias=f(G, d, scale=0.1))
    got = mamba_inner_grouped(*[torch.from_numpy(v) for v in args.values()],
                              nb=nb)
    want = j_inner_g(*[jnp.asarray(v) for v in args.values()], nb=nb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=6e-4,
                               atol=2e-3)


def test_cuda_dispatch_refuses_what_it_cannot_launch():
    """CPU tensors never reach the kernel wrapper, and a failed nvcc build
    raises instead of falling back."""
    inp = _inputs(0, b=1, L=8, d=4)
    t = {k: _to(v, "torch", torch.float32) for k, v in inp.items()}
    with pytest.raises(ValueError, match="CUDA tensors"):
        tss.selective_scan_fwd_cuda(t["u"], t["delta"], t["A"], t["B"],
                                    t["C"])
    with pytest.raises(ValueError, match="unknown implementation"):
        tss.selective_scan(t["u"], t["delta"], t["A"], t["B"], t["C"],
                           implementation="pallas")


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="build failed"):
        _build.build_all()
    assert not list(tmp_path.iterdir())


def test_channel_major_wrappers_match_jax():
    """selective_scan_cm (grouped B/C in the reference's (b, G, n, L)
    layout) and causal_conv1d_cm against the JAX wrappers."""
    from vivim_tpu.kernels.causal_conv1d import causal_conv1d_cm as j_conv_cm
    from vivim_tpu.kernels.selective_scan import selective_scan_cm as j_cm
    from vivim_tpu_torch.kernels.causal_conv1d import causal_conv1d_cm

    rng = np.random.default_rng(8)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    u, delta, z = f(2, 16, 50), 0.5 * f(2, 16, 50), f(2, 16, 50)
    A = -(0.5 + rng.random((16, 8))).astype(np.float32)
    B, C, D = f(2, 2, 8, 50), f(2, 2, 8, 50), f(16)
    t = lambda x: torch.from_numpy(x)
    got, got_last = tss.selective_scan_cm(
        t(u), t(delta), t(A), t(B), t(C), D=t(D), z=t(z),
        delta_softplus=True, return_last_state=True)
    want, want_last = j_cm(*map(jnp.asarray, (u, delta, A, B, C)),
                           D=jnp.asarray(D), z=jnp.asarray(z),
                           delta_softplus=True, return_last_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=6e-4,
                               atol=2e-3)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last),
                               rtol=6e-4, atol=2e-3)
    x, w = f(2, 16, 30), f(16, 4)
    np.testing.assert_allclose(
        causal_conv1d_cm(t(x), t(w), activation="silu").numpy(),
        np.asarray(j_conv_cm(jnp.asarray(x), jnp.asarray(w),
                             activation="silu")), rtol=1e-5, atol=1e-5)
