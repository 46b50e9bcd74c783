"""The port's sequence-sharded selective scan (``parallel/seq_scan.py``)
against the JAX package, on gloo process groups of the CPU.

The ranks (``tests/torch_parallel_helpers.py``) run the port; the oracle
is the JAX sequential scan (``implementation="ref"``) on one device, for
the output, the last state and the gradients of ``sum(y * w) +
sum(last ** 2)`` w.r.t. all eight inputs, at rtol / atol 2e-3
(``tests/test_seq_scan.py``), at S = 2 and 4 shards, with shared and
per-batch A / D / bias; an L that does not divide takes the one-device scan
with the JAX package's log line.  Once, the JAX ``seq_sharded_selective_
scan`` on a 2-device ``seq`` mesh of the CPU devices.  The body on a rank's
shards, ``seq_sharded_selective_scan_local``, against the JAX body of that
name under ``shard_map`` on an S-device ``seq`` mesh of the CPU devices
(each rank's output, last state and gradients).  The micro Vivim with its
Mamba layers sharded over 2 ranks: eval logits against the JAX forward at
1e-3, and one train step against the JAX ``make_train_step`` at
``test_torch_train_step.py``'s tolerances (``test_torch_seq_layer.py``
holds S = 4, the hybrid mesh and the layer's parts).
"""

import functools


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parallel_helpers as H
from vivim_tpu.convert.torch_to_jax import vivim_params_from_torch
from vivim_tpu.kernels import refs as jrefs
from vivim_tpu.nn.vivim import Vivim as JVivim
from vivim_tpu.nn.vivim import VivimConfig as JConfig
from jax.sharding import PartitionSpec as P

from vivim_tpu.parallel.mesh import make_mesh as jmake_mesh
from vivim_tpu.parallel.mesh import shard_map_compat
from vivim_tpu.parallel.seq_scan import (
    seq_sharded_selective_scan as jseq_scan,
)
from vivim_tpu.parallel.seq_scan import (
    seq_sharded_selective_scan_local as jseq_local,
)
from vivim_tpu.train import loop as jloop
from vivim_tpu_torch.kernels.selective_scan import selective_scan
from vivim_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

TOL = dict(rtol=2e-3, atol=2e-3)
CASES = {
    "shared": dict(seed=0, per_batch=False, b=2, d=8, n=4),
    "per_batch": dict(seed=3, per_batch=True, b=3, d=8, n=4),
    "indivisible": dict(seed=5, per_batch=False, b=2, d=8, n=4),
}


def _cases(S):
    out = {}
    for name, kw in CASES.items():
        L = S * 16 + (1 if name == "indivisible" else 0)
        out[name] = dict(kw, L=L)
    return out


_RUNS = {}


def _run(S, tmp_path_factory):
    """(S, output dir) of one group of S ranks over every case, run once
    per module."""
    if S not in _RUNS:
        out = tmp_path_factory.mktemp(f"seq{S}")
        H.run_ranks(H.seq_scan_body, S, out, _cases(S))
        _RUNS[S] = (S, out)
    return _RUNS[S]


@pytest.fixture(scope="module", params=[2, 4], ids=["S2", "S4"])
def seq_run(request, tmp_path_factory):
    return _run(request.param, tmp_path_factory)


def _jax_oracle(x):
    """The JAX one-device scan: y, last and the eight gradients."""
    args = tuple(jnp.asarray(x[k]) for k in H.SCAN_NAMES)
    w = jnp.asarray(x["w"])

    def loss(*a):
        y, last = jrefs.selective_scan_ref(*a, delta_softplus=True,
                                           return_last_state=True)
        return jnp.sum(y * w) + jnp.sum(last ** 2), (y, last)

    grads, (y, last) = jax.grad(loss, argnums=tuple(range(8)),
                                has_aux=True)(*args)
    return np.asarray(y), np.asarray(last), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("case", ["shared", "per_batch"])
def test_seq_scan_matches_jax(seq_run, case):
    S, out = seq_run
    x = H.scan_inputs(**_cases(S)[case])
    y, last, grads = _jax_oracle(x)
    for r in range(S):
        got = H.load(out, f"{case}_rank{r}")
        np.testing.assert_allclose(got["y"], y, **TOL)
        np.testing.assert_allclose(got["last"], last, **TOL)
        for name, g in zip(H.SCAN_NAMES, grads):
            np.testing.assert_allclose(got[f"d{name}"], g, **TOL,
                                       err_msg=f"d{name}, rank {r}")
        assert any(f"sharded over {S} 'seq'" in m for m in got["log"])


def test_forward_without_autograd_matches_jax(seq_run):
    S, out = seq_run
    for case in ("shared", "per_batch"):
        y, last, _ = _jax_oracle(H.scan_inputs(**_cases(S)[case]))
        for r in range(S):
            got = H.load(out, f"{case}_rank{r}")
            np.testing.assert_allclose(got["y_ng"], y, **TOL)
            np.testing.assert_allclose(got["last_ng"], last, **TOL)


def test_indivisible_length_runs_the_one_device_scan(seq_run):
    """L % S != 0: the JAX package's FALLBACK line, and the one-device scan
    on every rank."""
    S, out = seq_run
    case = _cases(S)["indivisible"]
    y, last, grads = _jax_oracle(H.scan_inputs(**case))
    for r in range(S):
        got = H.load(out, f"indivisible_rank{r}")
        assert any(f"seq-shard FALLBACK: L={case['L']} % {S}" in m
                   for m in got["log"])
        np.testing.assert_allclose(got["y"], y, **TOL)
        np.testing.assert_allclose(got["last"], last, **TOL)
        for name, g in zip(H.SCAN_NAMES, grads):
            np.testing.assert_allclose(got[f"d{name}"], g, **TOL)


def test_every_rank_holds_the_same_results(seq_run):
    """The outputs are gathered and the gradients summed or gathered over
    the group: every rank holds the same arrays, bit for bit."""
    S, out = seq_run
    for case in CASES:
        first = H.load(out, f"{case}_rank0")
        for r in range(1, S):
            got = H.load(out, f"{case}_rank{r}")
            for k, v in first.items():
                if k != "log":
                    np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_matches_the_jax_seq_mesh(tmp_path_factory):
    """The JAX ``seq_sharded_selective_scan`` on a 2-device ``seq`` mesh of
    the CPU devices gives what the port's 2 ranks give."""
    _, out = _run(2, tmp_path_factory)
    x = H.scan_inputs(**_cases(2)["shared"])
    y, last = jseq_scan(*(jnp.asarray(x[k]) for k in H.SCAN_NAMES),
                        mesh=jmake_mesh(2, axis="seq"), implementation="ref")
    for r in range(2):
        got = H.load(out, f"shared_rank{r}")
        np.testing.assert_allclose(got["y"], np.asarray(y), **TOL)
        np.testing.assert_allclose(got["last"], np.asarray(last), **TOL)


def _jax_local(x, S):
    """The JAX body under ``shard_map`` on an S-device ``seq`` mesh: the
    whole y, last and the eight gradients of sum(y * w) + sum(last ** 2)."""
    seq, rep = P(None, "seq", None), P()
    body = functools.partial(jseq_local, axis_name="seq",
                             implementation="ref")

    def wrapped(u, delta, A, B, C, D, z, bias):
        return body(u, delta, A, B, C, D=D, z=z, delta_bias=bias)

    fn = shard_map_compat(wrapped, jmake_mesh(S, axis="seq"),
                          (seq, seq, rep, seq, seq, rep, seq, rep),
                          (seq, rep))
    w = jnp.asarray(x["w"])

    def loss(*a):
        y, last = fn(*a)
        return jnp.sum(y * w) + jnp.sum(last ** 2), (y, last)

    grads, (y, last) = jax.grad(loss, argnums=tuple(range(8)), has_aux=True)(
        *(jnp.asarray(x[k]) for k in H.SCAN_NAMES))
    return np.asarray(y), np.asarray(last), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("case", ["shared", "per_batch"])
def test_local_body_matches_the_jax_body(seq_run, case):
    """Each rank's shard of the output, the global last state, its shards'
    gradients of u, delta, B, C and z and the group's of A, D and bias,
    against the JAX ``seq_sharded_selective_scan_local`` in ``shard_map``
    over as many CPU devices, and against the one-device oracle."""
    S, out = seq_run
    x = H.scan_inputs(**_cases(S)[case])
    ls = x["u"].shape[1] // S
    jy, jlast, jgrads = _jax_local(x, S)
    y, last, grads = _jax_oracle(x)
    np.testing.assert_allclose(jy, y, **TOL)
    for name, jg, g in zip(H.SCAN_NAMES, jgrads, grads):
        np.testing.assert_allclose(jg, g, **TOL, err_msg=f"JAX d{name}")
    for r in range(S):
        got = H.load(out, f"{case}_local_rank{r}")
        mine = lambda a: a[:, r * ls:(r + 1) * ls]
        np.testing.assert_allclose(got["y"], mine(jy), **TOL)
        np.testing.assert_allclose(got["last"], jlast, **TOL)
        for name, g in zip(H.SCAN_NAMES, jgrads):
            want = mine(g) if name in H.SEQ_SHARDED else g
            np.testing.assert_allclose(got[f"d{name}"], want, **TOL,
                                       err_msg=f"d{name}, rank {r}")


@pytest.mark.parametrize("kw,match", [
    (dict(delta_softplus=False), "delta_softplus=True"),
    (dict(delta_softplus=True, initial_state=torch.zeros(2, 8, 4)),
     "no initial_state")])
def test_sharded_scan_refuses_what_jax_refuses(kw, match):
    """The JAX package's ValueError, before any collective."""
    x = H.scan_inputs(seed=0, b=2, L=32, d=8, n=4, per_batch=False)
    mesh = Mesh({"seq": 2}, {"seq": 0}, {"seq": None})
    with pytest.raises(ValueError, match=match):
        selective_scan(*(torch.from_numpy(x[k]) for k in H.SCAN_NAMES),
                       seq_axis="seq", mesh=mesh, **kw)


# ------------------------------------------------------ the micro Vivim


@pytest.fixture(scope="module")
def seq_model_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("seq_model")
    H.run_ranks(H.seq_model_body, 2, out)
    return out


def _jax_pair(seed=0):
    """The JAX micro Vivim holding the port's seeded weights."""
    sd = {k: v.numpy() for k, v in H.port_model(seed).state_dict().items()}
    jcfg = H.no_dropout(JConfig.micro_test(scan_implementation="ref"))
    variables = jax.tree_util.tree_map(jnp.asarray,
                                       vivim_params_from_torch(sd, jcfg))
    return JVivim(jcfg), jcfg, variables


def test_vivim_forward_with_sharded_scans_matches_jax(seq_model_run):
    jmodel, _, variables = _jax_pair()
    clip = jnp.asarray(H.batch(5, B=2)["clip"])
    want = np.asarray(jax.jit(
        lambda v, c: jmodel.apply(v, c, deterministic=True))(variables, clip))
    for r in range(2):
        got = H.load(seq_model_run, f"seq2_rank{r}")["logits"]
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_vivim_train_step_with_sharded_scans_matches_jax(seq_model_run):
    """One step with every scan sharded over 2 ranks, the batch whole on
    both, against the JAX one-device step: loss rtol 1e-4, grad norm 1e-3,
    parameters rtol 1e-4 / atol 2e-5, BatchNorm statistics 1e-3 / 1e-4."""
    jmodel, jcfg, variables = _jax_pair()
    tx, _ = jloop.make_optimizer(1e-3, 5.0, 1)
    jstate = jloop.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]), rng=jax.random.PRNGKey(0))
    jstate, jm = jloop.make_train_step(jmodel, "recall_focused", 3, tx)(
        jstate, {k: jnp.asarray(v) for k, v in H.batch(0, B=2).items()})
    want = _flat_state(jstate)
    for r in range(2):
        got = H.load(seq_model_run, f"seq2_rank{r}")
        np.testing.assert_allclose(got["loss"], float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(got["grad_norm"], float(jm["grad_norm"]),
                                   rtol=1e-3)
        _assert_state_close(got, jcfg, want)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_state(jstate):
    return {"params": _flat(jstate.params),
            "batch_stats": _flat(jstate.batch_stats)}


# the biases that reach the train-mode BatchNorm only as per-channel
# shifts: their true gradient is 0 and both frameworks give them noise
# (test_torch_train_step.py)
ZERO_GRAD = ("['linear_c_0']['bias']", "['linear_c_1']['bias']",
             "['encoder']['mamba_1_0']['mlp']['fc2']['bias']")


def _assert_state_close(got, jcfg, want):
    """A rank's saved state_dict against the JAX state after the step."""
    sd = {k: v for k, v in got.items()
          if k not in ("loss", "jaccard", "grad_norm", "coords", "log",
                       "in_proj_tokens", "exchanges", "logits")}
    conv = vivim_params_from_torch(sd, jcfg)
    for what, tol in (("params", dict(rtol=1e-4, atol=2e-5)),
                      ("batch_stats", dict(rtol=1e-3, atol=1e-4))):
        flat = _flat(conv[what])
        for k, w in want[what].items():
            if what == "params" and k in ZERO_GRAD:
                continue
            np.testing.assert_allclose(flat[k], w, **tol,
                                       err_msg=f"{what}{k}")
