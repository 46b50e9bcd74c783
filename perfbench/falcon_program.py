"""Falcon-H1 in the benchmark: the program built from a configuration file,
its seeded weights, and the yardstick's arithmetic of a Falcon-H1 cell.

- ``init``: the seeded init of each parameter by its name (the
  configuration file's ``assumed`` says why): the Mamba-2 mixers' A, dt,
  D, conv and norms as Granite's (``granite_program.init``: mamba_ssm's
  ``Mamba2``), every other weight N(0, its std of ``STDS``), chosen so that
  at the published widths and µP multipliers the embedding and each
  branch that writes into the residual stream have about unit RMS, the
  logits about unit std, the attention scores a std of about 2.3 (peaked
  enough over 4096 keys that a stuck K/V position shows, not so peaked
  that bf16's rounding flips the attended keys layer after layer) and the
  Mamba-2 state a share of y comparable to D x.
- ``build``: the port's ``FalconH1LM`` made on the meta device, each
  weight drawn on the card from the seed and its name, in float32, then
  rounded to the configuration's dtype, and held by the model as drawn.
- ``reference_weight``: the same tensors drawn again for the plain
  reference, one at a time, upcast to float32.
- ``k1_work``, ``request_flops``, ``decode_bytes``: K1's work in a
  request's prefill, the analytic FLOPs of a generation request and the
  bytes a decode step must move, from the configuration alone (whatever
  implements them).

Beside ``programs.py``, ``jamba_program.py`` and ``granite_program.py``, a
module of the benchmark that imports the program (``vivim_tpu_torch``),
inside ``build``.
"""

from __future__ import annotations

import math

import torch

from perfbench import granite_program, traffic, weights, work
from perfbench.jamba_program import DTYPES
from perfbench.reference import falcon_h1 as ref

# the seeded init's stds by the parameter's last names (the configuration
# file's "assumed" gives the arithmetic at the published widths and the
# readings behind them): the embedding times 5.657 has unit RMS; the head's
# logits, times 1/128, a std of sqrt(5120) * 1.79 / 128 = 1; a score q .
# (0.011 k) / sqrt(128) a std of 5120 * 0.011 * QK ** 2 = 2.3 at QK 0.2
# (at 0.38, 8.2, 18 layers of so peaked attention turned bf16's rounding
# into a logit gap of 2.3 at the median token); in_proj at 0.2 gives B and C
# (times 0.25, then 0.177 and 0.5) a product over the 256 states near 13,
# so the state carries a share of y comparable to D x; o_proj, out_proj
# and down_proj write about unit RMS into the stream after their
# multipliers (0.0375, 0.0884, 0.0112); gate_proj at 0.1 puts silu's input
# (times 0.177) near unit std
STDS = {"embed_tokens.weight": 0.177, "lm_head.weight": 1.79,
        "q_proj.weight": 0.2, "k_proj.weight": 0.2,
        "v_proj.weight": 0.02, "o_proj.weight": 0.37,
        "in_proj.weight": 0.2, "out_proj.weight": 0.177,
        "gate_proj.weight": 0.1, "up_proj.weight": 0.02,
        "down_proj.weight": 0.55}
# the names whose init is Granite's (mamba_ssm's Mamba2, norms 1)
MAMBA2 = ("mamba.A_log", "mamba.dt_bias", "mamba.D", "mamba.conv1d.weight",
          "mamba.conv1d.bias")


def init(cfg, name, shape, gen, device):
    """Parameter ``name`` of ``shape``, float32, from ``gen``."""
    if name.endswith(MAMBA2) or "norm." in name:
        return granite_program.init(cfg, name, shape, gen, device)
    std = next(s for k, s in STDS.items() if name.endswith(k))
    return torch.randn(shape, generator=gen, device=device) * std


def draw(cfg, name, shape, seed, device):
    """Parameter ``name`` from its own stream of ``seed``, with the init of
    its kind, in the configuration's dtype."""
    gen = weights.generator(traffic.sub_seed(seed, "weights", name), device)
    return init(cfg, name, tuple(shape), gen, device).to(
        DTYPES[cfg["dtype"]])


def reference_weight(cfg, seed, device):
    """``weight(name)`` for ``reference.falcon_h1.forward``: the program's
    tensor drawn again, upcast to float32."""
    shapes = ref.names(cfg)
    return lambda name: draw(cfg, name, shapes[name], seed, device).float()


def build(cfg, seed, device):
    """(the port's ``FalconH1LM`` on ``device`` holding the seeded
    weights, its ``lm.lm_params`` dict)."""
    from vivim_tpu_torch.nn import falcon_h1, lm

    fcfg = falcon_h1.config_from_falcon_json(cfg)
    lm.check_kernel_config(fcfg, device)
    with torch.device("meta"):
        model = falcon_h1.FalconH1LM(fcfg)
    sd = {n: draw(cfg, n, s, seed, device) for n, s in ref.names(cfg).items()}
    if fcfg.tie_word_embeddings:
        sd["lm_head.weight"] = sd["model.embed_tokens.weight"]
    model.load_state_dict(sd, strict=True, assign=True)
    if fcfg.tie_word_embeddings:
        model.lm_head.weight = model.model.embed_tokens.weight
    return model.eval(), lm.lm_params(model)


def k1_work(cfg, batch, length, elem):
    """K1's work (bytes, fp32 operations, exps) over a prefill of (batch,
    length): one call a layer at (batch, length, d_ssm), reading the B and
    C of every group, and no z."""
    _, d, n, g, *_ = ref.dims(cfg)
    nbytes, ops, exps = work.scan_work(batch, length, d, n, elem)
    nbytes += batch * length * (2 * (g - 1) * n - d) * elem
    return work.total([(nbytes, ops, exps)] * cfg["num_hidden_layers"])


def request_flops(cfg, batch, prompt, new):
    """The FLOPs a generation request needs: the prefill of ``prompt``
    tokens and ``new`` decode steps of one token (the last step's too), per
    row: every projection, the conv, each query's scores and values over
    the keys before it, the head where logits are made (the prompt's last
    position and each step), and the scan's operations
    (``work.scan_work``)."""
    m, d, n, g, heads, _, w, ha, kv, hd, f, v = ref.dims(cfg)
    layers = cfg["num_hidden_layers"]
    cd = d + 2 * g * n
    per_token = 2 * layers * (m * (d + cd + heads) + d * m + w * cd
                              + 2 * m * ha * hd + 2 * m * kv * hd
                              + 3 * m * f)
    tokens = prompt + new
    pairs = prompt * (prompt + 1) // 2 + sum(prompt + t + 1
                                             for t in range(new))
    attn = layers * 4 * ha * hd * pairs
    head = 2 * m * v * (1 + new)
    scan = layers * work.scan_work(1, tokens, d, n, 4)[1]
    return batch * (tokens * per_token + attn + head + scan)


def decode_bytes(cfg, batch, prompt, new, elem):
    """The bytes a decode step must move, on average over the ``new``
    steps: every weight once (an untied embedding only the batch's rows,
    a tied one whole, as the head reads it), each layer's filled K/V
    positions read and one written, and each layer's conv state (in
    ``elem`` bytes) and fp32 ssm state read and written."""
    m, d, n, g, _, _, w, _, kv, hd, *_ = ref.dims(cfg)
    layers = cfg["num_hidden_layers"]
    tied = cfg.get("tie_word_embeddings", False)
    params = sum(math.prod(s) for name, s in ref.names(cfg).items()
                 if tied or name != "model.embed_tokens.weight")
    if not tied:
        params += batch * m
    filled = prompt + (new + 1) / 2
    cache = layers * batch * 2 * kv * hd * (filled + 1)
    states = layers * 2 * batch * ((d + 2 * g * n) * w * elem + d * n * 4)
    return (params + cache) * elem + states
