"""Jamba in the benchmark: the program built from a configuration file, its
seeded weights, and the yardstick's arithmetic of a Jamba cell.

- ``build``: the port's ``JambaLM`` made on the meta device, each weight
  drawn on the card from the seed and its name (``weights.py``'s init of its
  kind, in float32, then rounded to the configuration's dtype) and held by
  the model as drawn: the draw never holds two copies of the model.
- ``reference_weight``: the same tensors drawn again for the plain
  reference, one at a time, upcast to float32.
- ``bf16_peak``, ``request_flops``, ``decode_bytes``: the card's dense bf16
  rate, the analytic FLOPs of a generation request and the bytes a decode
  step must move, from the configuration alone (whatever implements the
  step).

Beside ``programs.py``, the one other module of the benchmark that imports
the program (``vivim_tpu_torch``), inside ``build``.
"""

from __future__ import annotations

import math

import torch

from perfbench import traffic, weights, work
from perfbench.reference import jamba as ref

# data sheets, dense bf16 tensor-core rates, FLOP/s (SXM parts at 700 W)
BF16 = {"H100 PCIe": 756e12, "H200": 989.4e12, "H100": 989.4e12}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def bf16_peak(name):
    """The dense bf16 FLOP/s of the card called ``name``."""
    for key, rate in BF16.items():
        if key in name:
            return rate
    raise RuntimeError(f"no bf16 peak for card {name!r}")


def draw(cfg, name, shape, seed, device):
    """Parameter ``name`` from its own stream of ``seed``, with the init of
    its kind, in the configuration's dtype."""
    t = weights.make({name: (tuple(shape), torch.float32)},
                     traffic.sub_seed(seed, "weights", name), device)[name]
    return t.to(DTYPES[cfg["dtype"]])


def reference_weight(cfg, seed, device):
    """``weight(name)`` for ``reference.jamba.forward``: the program's
    tensor drawn again, upcast to float32."""
    shapes = ref.names(cfg)
    return lambda name: draw(cfg, name, shapes[name], seed, device).float()


def build(cfg, seed, device):
    """(the port's ``JambaLM`` on ``device`` holding the seeded weights, its
    ``lm.lm_params`` dict)."""
    from vivim_tpu_torch.nn import jamba, lm

    jcfg = jamba.config_from_jamba_json(cfg)
    lm.check_kernel_config(jcfg, device)
    with torch.device("meta"):
        model = jamba.JambaLM(jcfg)
    sd = {n: draw(cfg, n, t.shape, seed, device)
          for n, t in model.state_dict().items()}
    model.load_state_dict(sd, strict=True, assign=True)
    return model.eval(), lm.lm_params(model)


def _layers(cfg):
    """(Mamba layers, attention layers, MoE layers, dense-MLP layers)."""
    n = range(cfg["num_hidden_layers"])
    attn = [i for i in n if ref.is_attention(cfg, i)]
    moe = [i for i in n if ref.has_experts(cfg, i)]
    return (len(n) - len(attn), len(attn), len(moe), len(n) - len(moe))


def k1_work(cfg, batch, length, elem):
    """K1's work (bytes, fp32 operations, exps) over a prefill of (batch,
    length): one call per Mamba layer at (batch, length, d_inner)."""
    _, d, n, *_ = ref.dims(cfg)
    return work.total([work.scan_work(batch, length, d, n, elem)]
                      * _layers(cfg)[0])


def request_flops(cfg, batch, prompt, new):
    """The FLOPs a generation request needs: the prefill of ``prompt``
    tokens and ``new`` decode steps of one token (the last step's too), per
    row: every projection, the routed experts only (top-k of each token,
    and the router), each query's scores and values over the keys before
    it, the head where logits are made (the prompt's last position and each
    step), and the scan's operations (``work.scan_work``)."""
    m, d, n, r, w, heads, kv, hd, f, e, v = ref.dims(cfg)
    n_mamba, n_attn, n_moe, n_dense = _layers(cfg)
    k = cfg["num_experts_per_tok"]
    per_token = 2 * (n_mamba * (m * 2 * d + d * (r + 2 * n) + r * d + d * m
                                + w * d)
                     + n_attn * (2 * m * heads * hd + 2 * m * kv * hd)
                     + n_dense * 3 * m * f + n_moe * (k * 3 * m * f + m * e))
    tokens = prompt + new
    pairs = prompt * (prompt + 1) // 2 + sum(prompt + t + 1
                                             for t in range(new))
    attn = n_attn * 4 * heads * hd * pairs
    head = 2 * m * v * (1 + new)
    scan = n_mamba * work.scan_work(1, tokens, d, n, 4)[1]
    return batch * (tokens * per_token + attn + head + scan)


def decode_bytes(cfg, batch, prompt, new, experts_per_step, elem):
    """The bytes a decode step must move, on average over the ``new``
    steps: every weight outside the experts once (of the embedding only
    the batch's rows), ``experts_per_step`` experts' weights (distinct
    experts chosen, summed over the MoE layers), each attention layer's
    filled K/V positions read and one written, and each Mamba layer's conv
    state (in ``elem`` bytes) and fp32 ssm state read and written."""
    m, d, n, _, w, _, kv, hd, f, *_ = ref.dims(cfg)
    n_mamba, n_attn, _, _ = _layers(cfg)
    shared = sum(math.prod(s) for name, s in ref.names(cfg).items()
                 if ".experts." not in name
                 and name != "model.embed_tokens.weight") + batch * m
    experts = experts_per_step * 3 * m * f
    filled = prompt + (new + 1) / 2
    cache = n_attn * batch * 2 * kv * hd * (filled + 1)
    states = n_mamba * 2 * batch * d * (w * elem + n * 4)
    return (shared + experts + cache) * elem + states
