"""The dropless MoE block's combine (``kernels/moe_combine.py``) on the CPU:
its plain version against the ``index_add_`` form the block used before it
and against a per-token loop, its argument checks, and its launch count.

The CUDA kernel itself runs in ``tests/test_torch_cuda.py`` (marked
``cuda``) and ``chip_smoke.py``.  Tolerances: the per-token loop takes the
same fp32 operations in the same order (each product rounded, then added,
j = 0 .. k-1, then the shared row), so it is bit-equal; the ``index_add_``
form adds a token's choices in expert order, not choice order, so fp32
agrees within rtol 1e-6 / atol 1e-6 (a few roundings of sums of order 1),
and bf16 within one bf16 rounding of the result (rtol 8e-3, atol 1e-2).
"""

import pytest
import torch

from vivim_tpu_torch.kernels import moe_combine as mc

torch.set_num_threads(1)

TOL = {torch.float32: (1e-6, 1e-6), torch.bfloat16: (8e-3, 1e-2)}
# (tokens, experts, k, M, shared): Granite-like (top-10 of 12 with a shared
# expert) and Jamba-like (top-2 of 16, none), ragged T and M
CASES = [(37, 12, 10, 24, True), (53, 16, 2, 40, False), (1, 4, 1, 8, True)]


def routed(tokens, experts, k, m, shared, dtype, seed=0):
    """The combine's operands as ``dropless_moe`` makes them: a random top
    k of each token, sorted by expert (stable), ``pos`` the inverse of the
    sort, expert outputs ``ys`` in sorted order, renormalised gates; and
    the sort's ``order`` for the ``index_add_`` form."""
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(tokens, experts, generator=g)
    top, chosen = torch.topk(logits, k, dim=-1)
    gates = torch.softmax(top, -1)
    order = torch.argsort(chosen.reshape(-1), stable=True)
    pos = torch.empty(tokens * k, dtype=torch.int32)
    pos[order] = torch.arange(tokens * k, dtype=torch.int32)
    ys = torch.randn(tokens * k, m, generator=g).to(dtype)
    sh = torch.randn(tokens, m, generator=g).to(dtype) if shared else None
    return ys, pos.view(tokens, k), gates, sh, order


def index_add_form(ys, gates, shared, order, k):
    """The block's combine before the kernel (``nn/moe.py``)."""
    rows = order // k
    out = torch.zeros((gates.shape[0], ys.shape[1]), dtype=torch.float32)
    out.index_add_(0, rows, ys.float() * gates.reshape(-1)[order, None])
    if shared is not None:
        out += shared.float()
    return out.to(ys.dtype)


def per_token_loop(ys, pos, gates, shared):
    out = []
    for t in range(pos.shape[0]):
        acc = torch.zeros(ys.shape[1])
        for j in range(pos.shape[1]):
            acc = acc + gates[t, j] * ys[int(pos[t, j])].float()
        if shared is not None:
            acc = acc + shared[t].float()
        out.append(acc.to(ys.dtype))
    return torch.stack(out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_plain_combine_matches_index_add_and_a_per_token_loop(case, dtype):
    tokens, experts, k, m, shared = case
    ys, pos, gates, sh, order = routed(tokens, experts, k, m, shared, dtype)
    before = mc.LAUNCHES
    got = mc.moe_combine(ys, pos, gates, sh)
    assert mc.LAUNCHES == before
    assert got.dtype == dtype and got.shape == (tokens, m)
    assert torch.equal(got, mc.plain_moe_combine(ys, pos, gates, sh))
    assert torch.equal(got, per_token_loop(ys, pos, gates, sh))
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got.float(), index_add_form(
        ys, gates, sh, order, k).float(), rtol=rtol, atol=atol)


def test_plain_combine_keeps_autograd_on_the_cpu():
    """The CPU path is plain PyTorch, so gradients flow through it to the
    expert outputs and the gates as through the ``index_add_`` form."""
    ys, pos, gates, sh, order = routed(9, 6, 3, 8, True, torch.float32)
    grads = []
    for fn in (lambda y, g: mc.moe_combine(y, pos, g, sh),
               lambda y, g: index_add_form(y, g, sh, order, 3)):
        y, g = ys.clone().requires_grad_(), gates.clone().requires_grad_()
        fn(y, g).pow(2).sum().backward()
        grads.append((y.grad, g.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def _bad(case):
    ys, pos, gates, sh, _ = routed(6, 5, 2, 8, True, torch.float32)
    if case == "float16":
        ys = ys.half()
    elif case == "pos_int64":
        pos = pos.long()
    elif case == "pos_negative":
        pos = pos.clone()
        pos[3, 1] = -1
    elif case == "pos_past_the_rows":
        pos = pos.clone()
        pos[0, 0] = ys.shape[0]
    elif case == "rows_not_t_k":
        ys = ys[:-1]
    elif case == "gates_shape":
        gates = gates[:, :1].contiguous()
    elif case == "gates_bf16":
        gates = gates.bfloat16()
    elif case == "shared_dtype":
        sh = sh.bfloat16()
    elif case == "shared_shape":
        sh = sh[:, :4].contiguous()
    elif case == "not_contiguous":
        ys = torch.randn(8, ys.shape[0]).t()
    elif case == "k_past_16":
        k = 17
        pos = torch.arange(6 * k, dtype=torch.int32).view(6, k)
        ys = torch.randn(6 * k, 8)
        gates = torch.rand(6, k)
    return ys, pos, gates, sh


@pytest.mark.parametrize("case", [
    "float16", "pos_int64", "pos_negative", "pos_past_the_rows",
    "rows_not_t_k", "gates_shape", "gates_bf16", "shared_dtype",
    "shared_shape", "not_contiguous", "k_past_16"])
def test_combine_refuses_what_the_kernel_does_not_take(case):
    before = mc.LAUNCHES
    with pytest.raises(ValueError):
        mc.moe_combine(*_bad(case))
    assert mc.LAUNCHES == before


def test_dropless_block_on_the_cpu_launches_nothing():
    """The block's CPU path runs the plain combine: ``LAUNCHES`` stays."""
    from vivim_tpu_torch.nn import moe

    g = torch.Generator().manual_seed(1)
    m, f, e = 16, 24, 6
    params = {"router.weight": torch.randn(e, m, generator=g)}
    for i in range(e):
        for name, shape in (("gate", (f, m)), ("up", (f, m)),
                            ("down", (m, f))):
            params[f"experts.{i}.{name}_proj.weight"] = 0.2 * torch.randn(
                *shape, generator=g)
    x = torch.randn(2, 7, m, generator=g)
    before = mc.LAUNCHES
    got = moe.dropless_moe(params, x, 2)
    assert mc.LAUNCHES == before
    torch.testing.assert_close(
        got.reshape(-1, m), moe.dropless_moe_step(params, x.reshape(-1, m), 2),
        rtol=1e-5, atol=1e-6)
