"""The sequence-sharded Mamba layers of the port (``nn/mamba.py``,
``nn/vivim.py``, ``parallel/comm.py``'s ``seq_*`` exchanges,
``train/loop.py::average_grads``) against the JAX package and the
one-device port, on gloo process groups of the CPU.

- Each exchange (halo, permute of one sequence and of several, gather
  partial, gather replicated, shard) at S = 2 and 4 against its one-rank
  meaning: its output, and the gradient of the sum of every rank's loss
  w.r.t. its input, from torch autograd on the whole tensors.
- The micro Vivim at S = 2, S = 4 and on the 2 x 2 ("data", "seq") mesh:
  eval logits within 1e-3 of the JAX forward; one train step against the
  JAX ``make_train_step`` at ``test_torch_train_step.py``'s tolerances;
  every parameter's reduced gradient (no clipping) within 1e-3 of its
  leaf's largest |grad| in the one-device port's step, a bound that a
  halved leaf and a mean over seq in place of the sum both fail; in_proj's
  output in every sharded MambaLayer holds L / S tokens; the exchanges'
  calls per forward.
- At S = 2, the step under ``-remat pre_scan`` and ``blocks`` against
  ``none``'s, and a step with every dropout on against the one-device
  port's from the same generator seed.  At S = 4, a clip whose second
  stage's 18 tokens do not divide: that stage runs whole, with the JAX
  package's FALLBACK line, and the logits still match the JAX forward.
  On the 2 x 2 mesh, ZeRO's step against the plain one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parallel_helpers as H
from tests.test_torch_seq_scan import _assert_state_close, _flat_state, _jax_pair
from vivim_tpu.train import loop as jloop
from vivim_tpu_torch.nn.mamba import _SCAN_PARAMS, direction_index
from vivim_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

LOGITS_TOL = dict(rtol=1e-3, atol=1e-3)
STEP_TOL = dict(rtol=1e-4, atol=2e-5)
GRAD_REL = 1e-3
# the biases that reach the train-mode BatchNorm only as per-channel
# shifts: their true gradient is 0 and both frameworks give them noise
# (test_torch_train_step.py)
PORT_ZERO_GRAD = ("decoder.linear_c.0.proj.bias",
                  "decoder.linear_c.1.proj.bias",
                  "encoder.stages.1.0.0.mlp.fc2.bias")
# the micro Vivim's stages at 2 frames of 32 px: 8x8 and 4x4 tokens a frame
STAGE_L = (128, 32)


_OUTS = {}


def _layout_out(layout, tmp_path_factory):
    """The output directory of a layout's group (``seq_model_body`` with
    its extras), run once per module."""
    if layout not in _OUTS:
        dp, n = H.SEQ_LAYOUTS[layout]
        out = tmp_path_factory.mktemp(layout)
        H.run_ranks(H.seq_model_body, dp * n, out, layout, True)
        _OUTS[layout] = out
    return _OUTS[layout]


@pytest.fixture(scope="module", params=list(H.SEQ_LAYOUTS))
def layout_run(request, tmp_path_factory):
    return request.param, _layout_out(request.param, tmp_path_factory)


@pytest.fixture(scope="module", params=[2, 4], ids=["S2", "S4"])
def exchange_run(request, tmp_path_factory):
    out = tmp_path_factory.mktemp(f"exchange{request.param}")
    H.run_ranks(H.seq_exchange_body, request.param, out)
    return request.param, out


_JAX = {}


def _jax_logits(size=32):
    if ("logits", size) not in _JAX:
        jmodel, _, variables = _jax_pair()
        clip = jnp.asarray(H.batch(5, B=2, S=size)["clip"])
        _JAX["logits", size] = np.asarray(jax.jit(
            lambda v, c: jmodel.apply(v, c, deterministic=True))(
                variables, clip))
    return _JAX["logits", size]


def _jax_step(B):
    """The JAX one-device step on ``batch(0, B)``: (config, metrics,
    state)."""
    if ("step", B) not in _JAX:
        jmodel, jcfg, variables = _jax_pair()
        tx, _ = jloop.make_optimizer(1e-3, 5.0, 1)
        jstate = jloop.TrainState(
            step=jnp.zeros((), jnp.int32), params=variables["params"],
            batch_stats=variables["batch_stats"],
            opt_state=tx.init(variables["params"]),
            rng=jax.random.PRNGKey(0))
        jstate, jm = jloop.make_train_step(jmodel, "recall_focused", 3, tx)(
            jstate, {k: jnp.asarray(v) for k, v in H.batch(0, B=B).items()})
        _JAX["step", B] = (jcfg, {k: float(v) for k, v in jm.items()},
                           _flat_state(jstate))
    return _JAX["step", B]


_PORT = {}


def _port_grads(B):
    """The one-device port's reduced (unclipped) gradients of the step on
    ``batch(0, B)``."""
    if B not in _PORT:
        _, state = H.train_run(None, 1, B=B, clip=False)
        _PORT[B] = {k: v.numpy() for k, v in H.grads_of(state.model).items()}
    return _PORT[B]


def _ranks(layout):
    dp, n = H.SEQ_LAYOUTS[layout]
    return range(dp * n)


def test_logits_match_jax(layout_run):
    layout, out = layout_run
    want = _jax_logits()
    for r in _ranks(layout):
        got = H.load(out, f"{layout}_rank{r}")["logits"]
        np.testing.assert_allclose(got, want, **LOGITS_TOL)


def test_train_step_matches_jax(layout_run):
    """Loss rtol 1e-4, grad norm 1e-3, parameters rtol 1e-4 / atol 2e-5,
    BatchNorm statistics 1e-3 / 1e-4 against the JAX one-device step on
    the global batch."""
    layout, out = layout_run
    jcfg, jm, want = _jax_step(H.layout_batch(layout))
    coords = set()
    for r in _ranks(layout):
        got = H.load(out, f"{layout}_rank{r}")
        coords.add(tuple(got["coords"]))
        np.testing.assert_allclose(got["loss"], jm["loss"], rtol=1e-4)
        np.testing.assert_allclose(got["grad_norm"], jm["grad_norm"],
                                   rtol=1e-3)
        _assert_state_close(got, jcfg, want)
    dp, n = H.SEQ_LAYOUTS[layout]
    assert coords == {(d, s) for d in range(dp) for s in range(n)}


def _grad_failures(got, want):
    """The leaves whose error exceeds GRAD_REL of their largest |grad| in
    ``want``: [(name, error, bound)]."""
    bad = []
    for k, w in want.items():
        if k[2:] in PORT_ZERO_GRAD:
            continue
        err = float(np.abs(got[k] - w).max())
        bound = GRAD_REL * float(np.abs(w).max())
        if not err <= bound:
            bad.append((k, err, bound))
    return bad


def _seq_partial_names(grads):
    """The leaves of the sharded Mamba layers that the train step sums
    over seq (all of every MambaLayer's but the scan's)."""
    return [k for k in grads if k.startswith("g:encoder.stages.")
            and not any(k.endswith(p) for p in _SCAN_PARAMS)]


def test_gradients_match_one_device(layout_run):
    """Each leaf's gradient after the reduction, on every rank, within
    1e-3 of its largest |grad| in the one-device port's step."""
    layout, out = layout_run
    want = _port_grads(H.layout_batch(layout))
    for r in _ranks(layout):
        got = H.load(out, f"{layout}_grads_rank{r}")
        assert set(got) - {"loss", "jaccard"} == set(want)
        assert _grad_failures(got, want) == [], f"rank {r}"


def test_the_gradient_bound_fails_a_mean_over_seq(layout_run):
    """The bound above fails every sharded layer's leaf when it is averaged
    over the seq row instead of summed (what a mean would leave: 1/S of
    it), and any leaf that is halved."""
    layout, out = layout_run
    n = H.SEQ_LAYOUTS[layout][1]
    want = _port_grads(H.layout_batch(layout))
    got = H.load(out, f"{layout}_grads_rank0")
    partial = _seq_partial_names(got)
    # per layer: norm1 2, in_proj 1, 3 directions x (conv 2, x_proj 1,
    # dt_proj weight 1), out_proj 1, norm2 2, the Mix-FFN 6
    assert len(partial) == 2 * 24
    meaned = dict(got, **{k: got[k] / n for k in partial})
    assert {k for k, _, _ in _grad_failures(meaned, want)} == {
        k for k in partial if k[2:] not in PORT_ZERO_GRAD}
    for k in (partial[0], "g:encoder.stages.0.0.0.mamba.A_log",
              "g:decoder.linear_fuse.weight"):
        assert [b[0] for b in _grad_failures(
            dict(got, **{k: got[k] / 2}), want)] == [k]


def test_mamba_layers_hold_their_token_shard(layout_run):
    """in_proj's output in every MambaLayer holds L / S tokens, and each
    stage logs its shard."""
    layout, out = layout_run
    n = H.SEQ_LAYOUTS[layout][1]
    for r in _ranks(layout):
        got = H.load(out, f"{layout}_rank{r}")
        assert got["in_proj_tokens"].tolist() == [L // n for L in STAGE_L]
        for i, L in enumerate(STAGE_L):
            assert any(m.startswith(f"seq-sharded Mamba stage {i}: L={L} "
                                    f"over {n} 'seq' ranks, {L // n} tokens")
                       for m in got["log"])
        assert not any("FALLBACK" in m for m in got["log"])


def test_exchange_calls_per_forward(layout_run):
    """Per sharded stage one gather back (its shard sends nothing in the
    forward); per MambaLayer two permutes (into the directions, back), one
    conv halo (a ``ppermute``) and one gathered 3-D conv."""
    layout, out = layout_run
    for r in _ranks(layout):
        got = H.load(out, f"{layout}_rank{r}")
        # sorted: gather_partial, gather_replicated, permute, shard
        assert got["exchanges"].tolist() == [2, 2, 4, 0]
        assert got["hops"] == 2


@pytest.mark.parametrize("remat", ["pre_scan", "blocks"])
def test_remat_under_seq_matches_none(tmp_path_factory, remat):
    """The step under ``-remat pre_scan`` / ``blocks`` at S = 2 ends where
    ``none``'s does (the recompute repeats the forward's exchanges on
    every rank in one order, or reads the saved halo)."""
    out = _layout_out("seq2", tmp_path_factory)
    for r in range(2):
        want = H.load(out, f"seq2_rank{r}")
        got = H.load(out, f"seq2_{remat}_rank{r}")
        for k, v in got.items():
            np.testing.assert_allclose(v, want[k], rtol=1e-5, atol=1e-7,
                                       err_msg=k)


def test_zero_under_seq_matches_the_hybrid_step(tmp_path_factory):
    """ZeRO over data on the 2 x 2 mesh (its one all_reduce sums the
    sharded layers' gradients over seq too) ends where the plain hybrid
    step does, at ZeRO's tolerance against data parallel (rtol / atol 2e-4,
    ``tests/test_fsdp.py``), with each leaf's first moment (0.1 x its
    clipped gradient: AdamW's first update hides a gradient's scale) within
    the gradient bound of the plain step's."""
    out = _layout_out("hybrid", tmp_path_factory)
    for r in range(4):
        want = dict(H.load(out, f"hybrid_rank{r}"),
                    **H.load(out, f"hybrid_mu_rank{r}"))
        got = H.load(out, f"hybrid_zero_rank{r}")
        for k, v in got.items():
            if not k.startswith("mu:"):
                np.testing.assert_allclose(v, want[k], rtol=2e-4, atol=2e-4,
                                           err_msg=k)
        mu = lambda d: {f"g:{k[3:]}": v for k, v in d.items()
                        if k.startswith("mu:")}
        assert len(mu(got)) == len(mu(want)) > 0
        assert _grad_failures(mu(got), mu(want)) == [], f"rank {r}"


def test_dropout_step_does_not_depend_on_s(tmp_path_factory):
    """Every dropout and drop-path on: the S = 2 step equals the one-device
    port's step from the same generator seed (each rank draws one device's
    masks and keeps its slice of the elementwise ones); the ranks of the
    seq row fold the same seed and end with the same generator state."""
    out = _layout_out("seq2", tmp_path_factory)
    ms, state = H.train_run(None, 1, B=2, dropout=True)
    want = {k: v.numpy() for k, v in state.model.state_dict().items()}
    ranks = [H.load(out, f"seq2_dropout_rank{r}") for r in range(2)]
    assert ranks[0]["seed"] == ranks[1]["seed"] == 0
    np.testing.assert_array_equal(ranks[0]["generator"],
                                  ranks[1]["generator"])
    np.testing.assert_array_equal(ranks[0]["generator"],
                                  state.generator.get_state().numpy())
    for got in ranks:
        np.testing.assert_allclose(got["loss"], ms[0]["loss"], rtol=1e-5)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, **STEP_TOL, err_msg=k)


def test_indivisible_stage_runs_whole(tmp_path_factory):
    """At 24 px the stages hold 2 x 6 x 6 = 72 and 2 x 3 x 3 = 18 tokens:
    over 4 ranks the first is sharded, the second runs whole with the JAX
    package's FALLBACK line; the logits match the JAX forward."""
    out = _layout_out("seq4", tmp_path_factory)
    want = _jax_logits(24)
    for r in range(4):
        got = H.load(out, f"seq4_odd_rank{r}")
        assert got["in_proj_tokens"].tolist() == [18, 18]
        assert any(m.startswith("seq-sharded Mamba stage 0: L=72 over 4")
                   for m in got["log"])
        assert not any("stage 1" in m for m in got["log"])
        assert any(m.startswith("seq-shard FALLBACK: L=18 % 4 shards")
                   for m in got["log"])
        np.testing.assert_allclose(got["logits"], want, **LOGITS_TOL)


def test_fold_seed_folds_the_data_index_only():
    """The ranks of a seq row draw the same masks (DropPath's per sample
    above all): their generator seed is one, each data row's its own."""
    seed = lambda d, s: Mesh({"data": 2, "seq": 2}, {"data": d, "seq": s},
                             {}).fold_seed(7)
    assert seed(0, 0) == seed(0, 1) == 7
    assert seed(1, 0) == seed(1, 1) != 7


# ------------------------------------------------------- the exchanges


def _one_device(name, x, w, S):
    """Each rank's output of exchange ``name`` and the gradient of the
    ranks' summed losses w.r.t. the whole inputs, by autograd on one
    device: (outputs per rank, {input: grad})."""
    leaves = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in x.items()}
    n, ls, c = H.X_SHAPE
    L, k = S * ls, H.X_HALO
    into, back = direction_index(L, H.X_FRAMES, torch.device("cpu"))
    mine = lambda t, r: t[..., r * ls:(r + 1) * ls, :]
    outs = []
    for r in range(S):
        v = leaves.get("x")
        if name == "halo":
            o = (v[:, r * ls - k:r * ls] if r else torch.zeros(n, k, c),)
        elif name == "permute":
            o = (torch.stack([mine(v[0][:, i], r) for i in into]),)
        elif name == "permute_each":
            o = (torch.stack([mine(v[p][:, i], r)
                              for p, i in enumerate(back)]),)
        elif name == "gather_partial":
            o = (mine(torch.cumsum(v, 1) ** 2, r),)
        elif name == "gather_replicated":
            o = (torch.tanh(v),)
        else:
            o = (mine(leaves["a"], r), mine(leaves["b"], r))
        outs.append(o)
    # every rank holds the same copy of the replicated loss: count it once
    ranks = [0] if name == "gather_replicated" else range(S)
    sum(H.exchange_loss(name, outs[r], w, r) for r in ranks).backward()
    return outs, {kk: v.grad for kk, v in leaves.items()}


@pytest.mark.parametrize("name", H.EXCHANGES)
def test_exchange_matches_its_one_rank_meaning(exchange_run, name):
    """Forward and adjoint: each rank's output equals its part of the
    one-device op, and the gradient it computes for its shard (the whole
    input, for ``shard``) equals that part of the one-device gradient of
    all ranks' losses."""
    S, out = exchange_run
    x = H.exchange_inputs(S)
    outs, grads = _one_device(name, x[name], x["w"], S)
    ls = H.X_SHAPE[1]
    for r in range(S):
        got = H.load(out, f"x_{name}_rank{r}")
        for i, o in enumerate(outs[r]):
            np.testing.assert_allclose(got[f"out{i}"], o.detach().numpy(),
                                       rtol=1e-6, atol=1e-6)
        for kk, g in grads.items():
            want = g.numpy() if name == "shard" else (
                g.numpy()[..., r * ls:(r + 1) * ls, :])
            np.testing.assert_allclose(got[f"g:{kk}"], want, rtol=1e-5,
                                       atol=1e-5, err_msg=f"d{kk} rank {r}")
