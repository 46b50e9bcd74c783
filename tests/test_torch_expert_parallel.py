"""Expert-parallel MoE of the port (``parallel/expert.py``) against the JAX
package's unsharded ``moe_ffn`` / ``MoEMambaLM``, on gloo process groups of
the CPU: the counterparts of ``tests/test_expert_parallel.py``'s 5 cases.

The JAX cases split 8 experts over an 8-device mesh (and a 2 x 4 ("data",
"expert") one); here 2 and 4 ranks split them, and 4 ranks form a 2 x 2
("data", "expert") mesh.  The oracle is the unsharded JAX function in this
process (its sequential scan for the LM), never the JAX expert-parallel
functions (their 8-device compiles keep that file in the slow tier).

Each rank backpropagates its own loss (``parallel/comm.py``'s
convention): on the expert mesh the same replicated loss, so a rank's
replicated leaves' gradients equal the JAX ones and its experts' the JAX
slice; on the ("data", "expert") mesh its data block's, so the JAX loss is
the sum over the data ranks and a leaf's JAX gradient the sum of the data
ranks' (the activations' own rows are each rank's alone).  The losses sum
over rows (sum(y^2), the next-token CE summed) plus the aux loss: the
global routing makes the aux loss every rank's.

Tolerances: outputs and logits within 1e-4 (the FFN 1e-5), aux within 1e-5
relative; every gradient within rtol 1e-4 / atol 1e-5 and each leaf's
largest error within 1e-3 of its largest |grad| (``chip_smoke.py``'s
``GRAD_REL``).  The data are chosen so that capacity drops tokens, and the
2 x 2 cases assert that routing each data shard alone would give another
answer on them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parallel_helpers as H
from tests.torch_lm_helpers import moe_pair
from vivim_tpu.nn import moe as jmoe
from vivim_tpu_torch.convert import from_jax
from vivim_tpu_torch.parallel import expert
from vivim_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

E = 8
LM_CFG = dict(vocab_size=40, d_model=16, n_layer=2, n_experts=E, d_ff=32,
              moe_every=1)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_REL = 1e-3
CF = 1.0  # the FFN cases' capacity factor: tokens drop


def _ffn_inputs():
    rng = np.random.default_rng(0)
    f = lambda s, *shape: (s * rng.standard_normal(shape)).astype(np.float32)
    return {"router_kernel": f(2.0, 16, E), "wi": f(0.1, E, 16, 32),
            "wo": f(0.1, E, 32, 16), "x": f(1.0, 4, 6, 16)}


def _jax_ffn(p, x, n_data=1):
    """JAX output, aux and gradients of sum(y^2) + n_data x 1e-2 aux."""
    jp = {k: jnp.asarray(v) for k, v in p.items()}

    def loss(jp, x):
        y, aux = jmoe.moe_ffn(jp, x, capacity_factor=CF)
        return jnp.sum(y ** 2) + n_data * 1e-2 * aux

    y, aux = jmoe.moe_ffn(jp, jnp.asarray(x), capacity_factor=CF)
    gp, gx = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    return dict(y=np.asarray(y), aux=float(aux), gx=np.asarray(gx),
                **{f"g:{k}": np.asarray(v) for k, v in gp.items()})


def _jax_lm(jmodel, params, toks, cfg, n_data=1):
    """JAX logits, aux and the state_dict-named gradients of the summed
    next-token CE + n_data x aux_loss_weight x aux."""
    def loss(p):
        logits, aux = jmodel.apply({"params": p}, toks)
        logp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), -1)
        ce = -jnp.take_along_axis(logp, toks[:, 1:, None], -1).sum()
        return ce + n_data * cfg.aux_loss_weight * aux

    logits, aux = jmodel.apply({"params": params}, toks)
    g = from_jax.moe_lm_state_dict_from_jax(jax.grad(loss)(params), cfg)
    return dict(logits=np.asarray(logits), aux=float(aux),
                grads={k: v.numpy() for k, v in g.items()})


def _check_grad(got, want, what):
    np.testing.assert_allclose(got, want, err_msg=what, **GRAD_TOL)
    scale = np.abs(want).max()
    assert scale > 0, what
    assert np.abs(got - want).max() <= GRAD_REL * scale, what


def _drops(p, x):
    """Whether capacity drops tokens when the whole batch routes."""
    probs = jax.nn.softmax(jnp.asarray(x.reshape(-1, 16))
                           @ p["router_kernel"], -1)
    d, _, _ = jmoe.moe_dispatch(probs, jmoe.moe_capacity(
        probs.shape[0], E, CF))
    return float(jnp.sum(d)) < probs.shape[0]


@pytest.fixture(scope="module")
def setup():
    ffn = _ffn_inputs()
    jmodel, params, _, cfg = moe_pair(LM_CFG, seed=21)
    toks = np.random.default_rng(22).integers(0, 40, (4, 8)).astype(
        np.int32)
    return ffn, (jmodel, params, cfg, toks)


def _spawn(tmp_path_factory, setup, world, hybrid):
    ffn, (jmodel, params, cfg, toks) = setup
    out = tmp_path_factory.mktemp(f"ep{world}")
    H.save(out, "ffn", **ffn)
    sd = from_jax.moe_lm_state_dict_from_jax(params, cfg)
    H.save(out, "lm", tokens=toks, **{k: v.numpy() for k, v in sd.items()})
    H.run_ranks(H.ep_body, world, out, LM_CFG, hybrid)
    return out


@pytest.fixture(scope="module")
def ep2(tmp_path_factory, setup):
    return _spawn(tmp_path_factory, setup, 2, False)


@pytest.fixture(scope="module")
def ep4(tmp_path_factory, setup):
    return _spawn(tmp_path_factory, setup, 4, True)


def _ranks(out, name, world):
    return [H.load(out, f"{name}_w{world}_rank{r}") for r in range(world)]


def _own(leaf, r, k):
    n = E // k
    return leaf[r * n:(r + 1) * n]


@pytest.mark.parametrize("world", [2, 4])
def test_ep_moe_ffn_matches_unsharded(world, request, setup):
    """Forward and gradients (router, wi, wo and x) over an expert axis of
    2 and 4 ranks: each rank's output, aux, router and x gradients are the
    JAX ones; a rank's wi / wo gradients hold its experts' JAX gradients
    and zeros elsewhere.  One gather forward and one all_reduce backward
    per rank."""
    ffn = setup[0]
    out = request.getfixturevalue(f"ep{world}")
    assert _drops(ffn, ffn["x"])
    want = _jax_ffn({k: v for k, v in ffn.items() if k != "x"}, ffn["x"])
    # bytes of one expert's (C, M) fp32 block
    ecm = jmoe.moe_capacity(int(np.prod(ffn["x"].shape[:2])), E, CF) * 16 * 4
    for r, got in enumerate(_ranks(out, "ep_ffn", world)):
        np.testing.assert_allclose(got["y"], want["y"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(got["aux"]), want["aux"], rtol=1e-5)
        for k in ("gx", "g:router_kernel"):
            _check_grad(got[k], want[k], f"rank {r} {k}")
        for k in ("g:wi", "g:wo"):
            _check_grad(_own(got[k], r, world), _own(want[k], r, world),
                        f"rank {r} {k}")
            mask = np.ones(E, bool)
            mask[r * E // world:(r + 1) * E // world] = False
            assert not got[k][mask].any(), f"rank {r} {k} off its experts"
        assert list(got["fwd_gathered"]) == [1, E // world * ecm]
        assert list(got["bwd_reduced"]) == [1, E * ecm]
        assert got["fwd_reduced"][0] == got["bwd_gathered"][0] == 0


def test_ep_requires_divisible_experts():
    """E = 6 over 4 ranks raises before any collective (no group needed)
    in every entry point."""
    mesh = Mesh({"expert": 4}, {"expert": 0}, {"expert": None})
    rng = np.random.default_rng(1)
    p = {"router_kernel": torch.randn(16, 6), "wi": torch.randn(6, 16, 32),
         "wo": torch.randn(6, 32, 16)}
    with pytest.raises(ValueError, match="not divisible"):
        expert.ep_moe_ffn(p, torch.from_numpy(
            rng.standard_normal((4, 16)).astype(np.float32)), mesh)
    with pytest.raises(ValueError, match="not divisible"):
        expert.split_ep_params({f"moe_0.{k}": v for k, v in p.items()},
                               mesh)
    from vivim_tpu_torch.nn.moe import MoEMambaLMConfig

    cfg = MoEMambaLMConfig(vocab_size=40, d_model=16, n_layer=1,
                           n_experts=6)
    with pytest.raises(ValueError, match="not divisible"):
        expert.lm_ep_forward(cfg, {}, torch.zeros(1, 4, dtype=torch.long),
                             mesh)


def _check_lm(got, want, rows=slice(None)):
    np.testing.assert_allclose(got["logits"], want["logits"][rows],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(got["aux"]), want["aux"], rtol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_ep_lm_forward_matches(world, request, setup):
    """``lm_ep_forward`` from each rank's ``split_ep_params``: logits and
    aux within 1e-4 / 1e-5 of ``MoEMambaLM.apply``, every replicated leaf's
    gradient the JAX one and bit-equal on every rank, each expert leaf's
    the JAX slice of its experts; 2 gathers forward and 2 all_reduces
    backward per rank (one each per MoE block)."""
    jmodel, params, cfg, toks = setup[1]
    out = request.getfixturevalue(f"ep{world}")
    want = _jax_lm(jmodel, params, jnp.asarray(toks), cfg)
    ranks = _ranks(out, "ep_lm", world)
    for r, got in enumerate(ranks):
        _check_lm(got, want)
        assert tuple(got["wi_shape"]) == (E // world, 16, 32)
        for k, w in want["grads"].items():
            g = got[f"g:{k}"]
            if k.split(".")[-1] in ("wi", "wo"):
                w = _own(w, r, world)
            else:
                np.testing.assert_array_equal(g, ranks[0][f"g:{k}"],
                                              err_msg=k)
            _check_grad(g, w, f"rank {r} {k}")
        assert got["fwd_gathered"][0] == cfg.n_layer
        assert got["bwd_reduced"][0] == cfg.n_layer
        assert got["fwd_reduced"][0] == got["bwd_gathered"][0] == 0


def test_ep_composes_with_dp_ffn(ep4, setup):
    """("data", "expert") 2 x 2: each rank its data block's rows of x; the
    routing is the whole batch's (capacity, slot order, aux), which routing
    each data shard alone would not give on these data.  Outputs, aux, x's
    gradient rows and, summed over the data ranks, the router's and each
    rank's experts' gradients are the JAX ones."""
    ffn = setup[0]
    p = {k: v for k, v in ffn.items() if k != "x"}
    x = ffn["x"]
    want = _jax_ffn(p, x, n_data=2)
    alone = np.concatenate([np.asarray(jmoe.moe_ffn(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x[i:i + 2]),
        capacity_factor=CF)[0]) for i in (0, 2)])
    assert np.abs(alone - want["y"]).max() > 1e-3
    ranks = _ranks(ep4, "dp_ep_ffn", 4)
    for r, got in enumerate(ranks):
        d, e = divmod(r, 2)
        rows = slice(2 * d, 2 * d + 2)
        np.testing.assert_allclose(got["y"], want["y"][rows], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(float(got["aux"]), want["aux"], rtol=1e-5)
        _check_grad(got["gx"], want["gx"][rows], f"rank {r} x")
        assert got["fwd_gathered"][0] == 2 and got["bwd_reduced"][0] == 2
    for e in range(2):
        g = ranks[e]["g:router_kernel"] + ranks[2 + e]["g:router_kernel"]
        _check_grad(g, want["g:router_kernel"], f"router, expert rank {e}")
        for k in ("g:wi", "g:wo"):
            g = _own(ranks[e][k] + ranks[2 + e][k], e, 2)
            _check_grad(g, _own(want[k], e, 2), f"{k}, expert rank {e}")


def test_ep_lm_composes_with_dp(ep4, setup):
    """``lm_ep_forward(batch_axis="data")`` on the 2 x 2 mesh: each rank's
    rows of the JAX logits (which a forward of each data shard alone does
    not give), the global aux; every leaf's gradient summed over the data
    ranks is the JAX one (of the data ranks' summed losses)."""
    jmodel, params, cfg, toks = setup[1]
    want = _jax_lm(jmodel, params, jnp.asarray(toks), cfg, n_data=2)
    alone = np.concatenate([np.asarray(jmodel.apply(
        {"params": params}, jnp.asarray(toks[i:i + 2]))[0]) for i in (0, 2)])
    assert np.abs(alone - want["logits"]).max() > 1e-3
    ranks = _ranks(ep4, "dp_ep_lm", 4)
    for r, got in enumerate(ranks):
        d, e = divmod(r, 2)
        assert list(got["coords"]) == [d, e]
        _check_lm(got, want, rows=slice(2 * d, 2 * d + 2))
        assert got["fwd_gathered"][0] == 2 * cfg.n_layer
        assert got["bwd_reduced"][0] == 2 * cfg.n_layer
    for e in range(2):
        for k, w in want["grads"].items():
            g = ranks[e][f"g:{k}"] + ranks[2 + e][f"g:{k}"]
            if k.split(".")[-1] in ("wi", "wo"):
                w = _own(w, e, 2)
            _check_grad(g, w, f"{k}, expert rank {e}")
