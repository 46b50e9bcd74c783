"""The PyTorch port's CUDA kernel on the card, against its plain version.

Marked ``cuda``: each test skips without a CUDA device.  The file imports
torch and the port only, so it runs on a machine without JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest`` because tests/conftest.py sets up JAX.)  Tolerances are
the JAX suite's: fp32 rtol 6e-4 / atol 2e-3, bf16 rtol 3e-2 / atol 5e-2;
model logits atol 1e-3.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vivim_tpu_torch.kernels import refs
from vivim_tpu_torch.kernels import selective_scan as ss

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (6e-4, 2e-3), torch.bfloat16: (3e-2, 5e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _inputs(dev, b=3, L=333, d=160, n=16, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(dev)
    bc = f(b, L, 2 * n)  # B and C as strided column views, as on the path
    return dict(u=f(b, L, d), delta=0.5 * f(b, L, d),
                A=-(0.5 + torch.from_numpy(rng.random((b, d, n)).astype(
                    np.float32)).to(dev)),
                B=bc[..., :n], C=bc[..., n:], D=f(b, d), z=f(b, L, d),
                delta_bias=0.1 * f(b, d), initial_state=f(b, d, n))


def _scan(fn, t, dtype):
    kw = dict(t)
    seq = [kw.pop(k).to(dtype) for k in ("u", "delta")]
    A = kw.pop("A")
    B, C = kw.pop("B").to(dtype), kw.pop("C").to(dtype)
    kw["z"] = kw["z"].to(dtype)
    return fn(*seq, A, B, C, delta_softplus=True, return_last_state=True,
              **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda, dtype):
    """Ragged L and d, per-batch A/D/bias, initial and last state."""
    t = _inputs(cuda)
    with torch.no_grad():
        before = ss.LAUNCHES
        got = _scan(ss.selective_scan, t, dtype)
        assert ss.LAUNCHES == before + 1
        want = _scan(refs.selective_scan_ref, t, dtype)
    torch.cuda.synchronize()
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    rtol, atol = TOL[dtype]
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol, atol=atol)


def test_grouped_bc_and_shared_params(cuda):
    """Grouped B/C fold into the batch; shared (D, N) A with batch stride
    0; no z, D or bias."""
    rng = np.random.default_rng(1)
    f = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(cuda)
    u, delta = f(2, 100, 32), 0.5 * f(2, 100, 32)
    A = -(0.5 + torch.rand(32, 16, device=cuda))
    B, C = f(2, 100, 2, 16), f(2, 100, 2, 16)
    with torch.no_grad():
        got = ss.selective_scan(u, delta, A, B, C, delta_softplus=True)
        want = refs.selective_scan_ref(u, delta, A, B, C,
                                       delta_softplus=True)
    torch.testing.assert_close(got, want, rtol=6e-4, atol=2e-3)


def test_cuda_refuses_what_has_no_kernel(cuda):
    t = _inputs(cuda, b=1, L=16, d=8)
    with pytest.raises(NotImplementedError, match="K2"):
        _scan(ss.selective_scan, dict(t, u=t["u"].requires_grad_(True)),
              torch.float32)
    with pytest.raises(NotImplementedError, match="constant"):
        with torch.no_grad():
            ss.selective_scan(t["u"], t["delta"], t["A"][0],
                              torch.randn(8, 16, device=cuda),
                              t["C"])
    with pytest.raises(ValueError, match="d_state"):
        with torch.no_grad():
            ss.selective_scan(t["u"], t["delta"], t["A"][..., :8],
                              t["B"][..., :8], t["C"][..., :8])


def test_tiny_vivim_kernel_vs_plain_scan(cuda):
    """A whole (tiny) model on the card: one launch per MambaLayer, logits
    within 1e-3 of the same model on the plain scan."""
    from vivim_tpu_torch.nn.layers import init_weights
    from vivim_tpu_torch.nn.vivim import Vivim, VivimConfig

    cfg = VivimConfig.tiny_test(scan_implementation=None)
    model = init_weights(Vivim(cfg), torch.Generator().manual_seed(0))
    ref = Vivim(dataclasses.replace(cfg, scan_implementation="ref"))
    ref.load_state_dict(model.state_dict())
    model, ref = model.to(cuda).eval(), ref.to(cuda).eval()
    clip = torch.randn(1, 3, 48, 48, 3, device=cuda)
    with torch.inference_mode():
        before = ss.LAUNCHES
        got = model(clip)
        assert ss.LAUNCHES - before == sum(cfg.depths)
        want = ref(clip)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
