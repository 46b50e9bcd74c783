"""Data parallel and ZeRO training of the port (``parallel/``,
``train/loop.py``) against the JAX package, on gloo process groups of the
CPU.

Two ranks each take their block of a global batch of 4 micro-Vivim clips
(``tests/torch_parallel_helpers.py``); the oracle is the JAX
``make_train_step`` on the whole batch, on one device, from the same
weights (dropout 0, as in ``test_torch_train_step.py``, whose tolerances
these are: loss rtol 1e-4, parameters rtol 1e-4 / atol 2e-5, BatchNorm
statistics rtol 1e-3 / atol 1e-4; the grad norm at rtol 1e-4, as
``tests/test_fsdp.py`` holds it).  ZeRO's two steps equal data parallel's
at rtol / atol 2e-4 (``tests/test_fsdp.py``), with real sharding engaged
(the leaves of 64 elements or more, as there).  A 2 x 2 ("data", "seq")
mesh, the eval step on a batch that splits and on one that does not, the
ZeRO leaf rule and state bytes against the JAX ones, and a failing rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parallel_helpers as H
from vivim_tpu.convert.torch_to_jax import vivim_params_from_torch
from vivim_tpu.nn.vivim import Vivim as JVivim
from vivim_tpu.nn.vivim import VivimConfig as JConfig
from vivim_tpu.parallel import fsdp as jfsdp
from vivim_tpu.parallel.mesh import make_mesh as jmake_mesh
from vivim_tpu.train import loop as jloop
from vivim_tpu_torch.data.loader import block_rows
from vivim_tpu_torch.nn.layers import init_weights
from vivim_tpu_torch.nn.vivim import Vivim, VivimConfig
from vivim_tpu_torch.parallel import fsdp
from vivim_tpu_torch.parallel.mesh import Mesh, shard_batch
from vivim_tpu_torch.train import loop

torch.set_num_threads(1)

STEP_TOL = dict(rtol=1e-4, atol=2e-5)
BN_TOL = dict(rtol=1e-3, atol=1e-4)
# the biases that reach the train-mode BatchNorm only as per-channel
# shifts: their true gradient is 0 and both frameworks give them noise
# (test_torch_train_step.py)
ZERO_GRAD = ("['linear_c_0']['bias']", "['linear_c_1']['bias']",
             "['encoder']['mamba_1_0']['mlp']['fc2']['bias']")
# the same biases under the port's names
PORT_ZERO_GRAD = ("decoder.linear_c.0.proj.bias",
                  "decoder.linear_c.1.proj.bias",
                  "encoder.stages.1.0.0.mlp.fc2.bias")
METRICS = ("loss", "jaccard", "grad_norm", "coords")


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp")
    H.run_ranks(H.dp_body, 2, out)
    return out


@pytest.fixture(scope="module")
def hybrid_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("hybrid")
    H.run_ranks(H.hybrid_body, 4, out)
    return out


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_setup(lr, wd, total_steps, seed=0):
    sd = {k: v.numpy() for k, v in H.port_model(seed).state_dict().items()}
    jcfg = H.no_dropout(JConfig.micro_test(scan_implementation="ref"))
    variables = jax.tree_util.tree_map(jnp.asarray,
                                       vivim_params_from_torch(sd, jcfg))
    tx, _ = jloop.make_optimizer(lr, wd, total_steps)
    state = jloop.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]), rng=jax.random.PRNGKey(0))
    return JVivim(jcfg), jcfg, state, tx


_JAX_RUNS = {}


def _jax_steps(n_steps, grad_accum=1, lr=1e-3, wd=5.0,
               loss="recall_focused"):
    """(cfg, metrics per step, flat state) of the JAX steps on the whole
    batches, run once per module for each argument set."""
    key = (n_steps, grad_accum, lr, wd, loss)
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = _run_jax_steps(*key)
    return _JAX_RUNS[key]


def _run_jax_steps(n_steps, grad_accum, lr, wd, loss):
    jmodel, jcfg, state, tx = _jax_setup(lr, wd, n_steps)
    step = jloop.make_train_step(jmodel, loss, 3, tx, grad_accum=grad_accum)
    ms = []
    for i in range(n_steps):
        state, m = step(state, {k: jnp.asarray(v)
                                for k, v in H.batch(i).items()})
        ms.append({k: float(v) for k, v in m.items()})
    return jcfg, ms, {"params": _flat(state.params),
                      "batch_stats": _flat(state.batch_stats)}


def _assert_state_close(got, jcfg, want):
    sd = {k: v for k, v in got.items() if k not in METRICS}
    conv = vivim_params_from_torch(sd, jcfg)
    for what, tol in (("params", STEP_TOL), ("batch_stats", BN_TOL)):
        flat = _flat(conv[what])
        assert set(want[what]) <= set(flat)
        for k, w in want[what].items():
            if what == "params" and k in ZERO_GRAD:
                continue
            np.testing.assert_allclose(flat[k], w, **tol,
                                       err_msg=f"{what}{k}")


def test_dp_step_matches_jax(dp_run):
    jcfg, (jm,), want = _jax_steps(1)
    for r in range(2):
        got = H.load(dp_run, f"dp1_rank{r}")
        np.testing.assert_allclose(got["loss"], jm["loss"], rtol=1e-4)
        np.testing.assert_allclose(got["jaccard"], jm["jaccard"], rtol=1e-6)
        np.testing.assert_allclose(got["grad_norm"], jm["grad_norm"],
                                   rtol=1e-4)
        _assert_state_close(got, jcfg, want)


def test_dp_step_with_batch_weighted_loss_matches_jax(dp_run):
    """``combined_focal_dice``: its focal alphas come from the batch's
    class counts, which the ranks sum over ``data``
    (``losses.batch_group``), as the JAX step counts the whole batch."""
    jcfg, (jm,), want = _jax_steps(1, loss="combined_focal_dice")
    for r in range(2):
        got = H.load(dp_run, f"dp_focal_rank{r}")
        np.testing.assert_allclose(got["loss"], jm["loss"], rtol=1e-4)
        np.testing.assert_allclose(got["grad_norm"], jm["grad_norm"],
                                   rtol=1e-4)
        _assert_state_close(got, jcfg, want)


def test_dp_edge_step_matches_one_process(dp_run):
    """The edge head and the multiclass edge criterion, whose balanced
    BCE weighs by the batch's edge pixel counts: two ranks' step equals
    the one-process step on the whole batch (which
    ``test_torch_edge_binary.py`` holds against JAX)."""
    (m,), state = H.train_run(Mesh({"data": 1}, {"data": 0}, {"data": None}),
                              1, with_edge=True)
    want = {k: v.numpy() for k, v in state.model.state_dict().items()}
    for r in range(2):
        got = H.load(dp_run, f"dp_edge_rank{r}")
        np.testing.assert_allclose(got["loss"], m["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], m["grad_norm"],
                                   rtol=1e-4)
        for k, v in want.items():
            if k not in PORT_ZERO_GRAD:
                np.testing.assert_allclose(got[k], v, **STEP_TOL,
                                           err_msg=k)


def test_dp_grad_accum_matches_jax(dp_run):
    """Three steps of two micro-batches: each rank's i-th micro-batch is
    its block of the global i-th, so the decode BatchNorm sees the JAX
    step's micro-batches."""
    jcfg, jms, want = _jax_steps(3, grad_accum=2)
    for r in range(2):
        got = H.load(dp_run, f"dp_accum_rank{r}")
        np.testing.assert_allclose(got["loss"], [m["loss"] for m in jms],
                                   rtol=1e-4)
        np.testing.assert_allclose(got["grad_norm"],
                                   [m["grad_norm"] for m in jms], rtol=1e-4)
        _assert_state_close(got, jcfg, want)


def test_zero_steps_match_data_parallel(dp_run):
    dp = H.load(dp_run, "dp2_rank0")
    for r in range(2):
        z = H.load(dp_run, f"zero2_rank{r}")
        assert int(z["n_sharded"]) >= 10  # real sharding engaged
        np.testing.assert_allclose(z["grad_norm"], dp["grad_norm"],
                                   rtol=1e-4)
        for k, v in dp.items():
            if k != "grad_norm":
                np.testing.assert_allclose(z[k], v, rtol=2e-4, atol=2e-4,
                                           err_msg=k)


def test_zero_state_bytes(dp_run):
    """Each rank holds at most half of data parallel's parameters and
    moments beside the replicated leaves; at rest the model's own sharded
    tensors are empty; the bytes equal the JAX package's analytic ones on
    params + mu + nu (its tree lacks the port's per-stage SegFormer
    LayerNorms, kept replicated)."""
    model = H.port_model(0)
    state = loop.create_train_state(model, 1e-3, 0.01, 2, seed=0)
    specs = fsdp.fsdp_state_shardings(
        state, Mesh({"data": 2}, {"data": 0}, {"data": None}),
        min_shard_elems=H.MIN_ELEMS)
    params = dict(model.named_parameters())
    repl = sum(3 * params[k].numel() * 4 for k, d in specs.items()
               if d is None)
    for r in range(2):
        z = H.load(dp_run, f"zero2_rank{r}")
        assert int(z["zero_bytes"]) <= 0.5 * (int(z["dp_bytes"]) - repl) + repl
        assert int(z["at_rest"]) == sum(params[k].numel()
                                        for k, d in specs.items() if d is None)
    _, jcfg, jstate, _ = _jax_setup(1e-3, 0.01, 2)
    sh = jfsdp.fsdp_state_shardings(jstate, jmake_mesh(2),
                                    min_shard_elems=H.MIN_ELEMS)
    want = 3 * jfsdp.state_bytes_per_device(jstate.params, sh.params)
    port_only = sum(3 * p.numel() * 4 for k, p in params.items()
                    if k.startswith("encoder.downsample_layers.layer_norm."))
    assert int(z["zero_bytes"]) - port_only == want


@pytest.mark.parametrize("B", [4, 3])
def test_eval_step_matches_jax(dp_run, B):
    """A batch of 4 splits over the 2 ranks, a batch of 3 runs whole on
    each: both give the JAX eval step's loss and counters on the whole
    batch."""
    jmodel, _, jstate, _ = _jax_setup(1e-3, 0.0, 1, seed=3)
    jl, jconf, jcm = jloop.make_eval_step(jmodel, "recall_focused", 3)(
        jstate, {k: jnp.asarray(v) for k, v in H.batch(7, B).items()})
    for r in range(2):
        got = H.load(dp_run, f"eval{B}_rank{r}")
        np.testing.assert_allclose(got["loss"], float(jl), rtol=1e-4)
        np.testing.assert_array_equal(got["conf"], np.asarray(jconf))
        np.testing.assert_array_equal(got["cm"], np.asarray(jcm))
        assert got["preds"].shape == (B * 2, 32, 32)


def test_hybrid_step_matches_jax(hybrid_run):
    """A 2 x 2 ("data", "seq") mesh: each data row holds its block, each
    seq column shards the scans; every rank ends at the JAX one-device
    step on the whole batch."""
    jcfg, (jm,), want = _jax_steps(1)
    coords = set()
    for r in range(4):
        got = H.load(hybrid_run, f"hybrid_rank{r}")
        coords.add(tuple(got["coords"]))
        np.testing.assert_allclose(got["loss"], jm["loss"], rtol=1e-4)
        np.testing.assert_allclose(got["grad_norm"], jm["grad_norm"],
                                   rtol=1e-4)
        _assert_state_close(got, jcfg, want)
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("min_elems", [H.MIN_ELEMS, fsdp.MIN_SHARD_ELEMS])
def test_leaf_rule_picks_the_jax_dim(n, min_elems):
    """For every leaf of the tiny Vivim, the port shards the dimension the
    JAX ``_leaf_spec`` shards, under the converter's key map: each port
    tensor varies along its sharded dimension only, and the converted JAX
    leaf must then vary along the JAX pick only."""
    cfg = VivimConfig.tiny_test()
    model = init_weights(Vivim(cfg), torch.Generator().manual_seed(0))
    state = loop.create_train_state(model, 1e-3, 0.0, 1, seed=0)
    specs = fsdp.fsdp_state_shardings(
        state, Mesh({"data": n}, {"data": 0}, {"data": None}),
        min_shard_elems=min_elems)
    sd = {}
    for k, v in model.state_dict().items():
        d = specs.get(k)
        if d is None:
            sd[k] = np.ones(v.shape, np.float32)
        else:
            shape = [1] * v.dim()
            shape[d] = v.shape[d]
            sd[k] = np.broadcast_to(
                np.arange(1, v.shape[d] + 1, dtype=np.float32)
                .reshape(shape), v.shape).copy()
    jcfg = JConfig.tiny_test()
    tree = vivim_params_from_torch(sd, jcfg)["params"]
    n_sharded = 0
    for key, leaf in _flat(tree).items():
        spec = tuple(jfsdp._leaf_spec(jnp.zeros(leaf.shape), n, "data",
                                      min_elems))
        want = [a for a, s in enumerate(spec) if s == "data"]
        got = [a for a in range(leaf.ndim) if leaf.shape[a] > 1
               and not np.all(np.diff(leaf, axis=a) == 0)]
        assert got == want, (key, leaf.shape, got, want)
        n_sharded += bool(want)
    assert n_sharded >= (10 if min_elems == H.MIN_ELEMS else 0)


def test_micro_batch_blocks_follow_the_global_micro_batches():
    """``block_rows``: rank r's i-th local micro-batch is its block of the
    global i-th; the loader's process split and ``shard_batch`` agree."""
    assert block_rows(8, 0, 2) == [0, 1, 2, 3]
    assert block_rows(8, 1, 2, micro_batches=2) == [2, 3, 6, 7]
    b = {"clip": np.arange(8), "paths": ["x"]}
    got = shard_batch(b, Mesh({"data": 2}, {"data": 1}, {"data": None}),
                      micro_batches=2)
    assert got["clip"].tolist() == [2, 3, 6, 7] and got["paths"] == ["x"]
    with pytest.raises(ValueError, match="micro-batches"):
        block_rows(6, 0, 2, micro_batches=2)


def test_a_failing_rank_fails_the_group_fast(tmp_path):
    """A rank that raises while the other waits in a collective: the
    harness kills the group and re-raises the rank's traceback, well
    inside the test's limit."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        H.run_ranks(H.failing_body, 2, tmp_path, wall_s=60)
