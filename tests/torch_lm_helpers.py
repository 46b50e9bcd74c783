"""Shared set-up of the LM parity tests (``tests/test_torch_lm*.py``,
``test_torch_quant.py``): a JAX ``MambaLM`` with weights from a seed and the
port's ``MambaLM`` holding the same weights."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vivim_tpu.nn import lm as jlm
from vivim_tpu_torch.convert import from_jax
from vivim_tpu_torch.nn import lm as tlm

VOCAB, D_MODEL, N_LAYER = 50, 16, 2       # the vocabulary pads to 56


class ToyTokenizer:
    """Char-level: 'a'..'z' -> 1..26; eos 0."""

    eos_token_id = 0

    def encode(self, s):
        return [max(1, min(26, ord(c) - 96)) for c in s if c.isalpha()]

    def decode(self, ids):
        return "".join(chr(96 + i) for i in ids if 1 <= i <= 26)


def perturb(params, seed):
    """Norm weights, dt biases and D off their init values, so that every
    term of the forward counts in a comparison."""
    rng = np.random.default_rng(seed)
    out = jax.tree_util.tree_map(np.asarray, params)

    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ("scale", "bias", "D", "dt_proj_bias"):
                node[k] = (v + rng.normal(0, 0.2, v.shape)).astype(np.float32)

    walk(out)
    return jax.tree_util.tree_map(jnp.asarray, out)


def make_pair(seed=0, vocab=VOCAB, d_model=D_MODEL, n_layer=N_LAYER,
              **cfg_kw):
    """(JAX model, JAX params (no "params" wrapper), port model)
    with the same weights; both on their sequential scans' config."""
    jcfg = jlm.MambaLMConfig(vocab_size=vocab, d_model=d_model,
                             n_layer=n_layer, **cfg_kw)
    jmodel = jlm.MambaLM(jcfg, scan_implementation="ref")
    params = jmodel.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, 4), jnp.int32))["params"]
    params = perturb(params, seed + 100)
    tmodel = tlm.MambaLM(tlm.MambaLMConfig(
        vocab_size=vocab, d_model=d_model, n_layer=n_layer, **cfg_kw))
    tmodel.load_state_dict(
        from_jax.mamba_lm_state_dict_from_jax(params, n_layer), strict=True)
    return jmodel, params, tmodel.eval()


def tokens(shape, seed=1, vocab=VOCAB):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def to_bf16(params):
    """Every floating tensor of a port parameter dict in bf16 (the bench's
    ``--dtype bfloat16``)."""
    return {k: v.to(torch.bfloat16) if v.is_floating_point() else v
            for k, v in params.items()}
