"""Granite 4.0-H in the benchmark: the program built from a configuration
file, its seeded weights, and the yardstick's arithmetic of a Granite cell.

- ``init``: the seeded init of each parameter by its name (the
  configuration file's ``assumed`` says why): Mamba-2's as mamba_ssm's
  ``Mamba2`` draws it (A = U[1, 16] through its log into ``A_log``, dt
  log-uniform in [1e-3, 0.1], floored at 1e-4, through the inverse
  softplus into ``dt_bias``, D = 1), the depthwise conv U(+-width^-0.5),
  norms 1, the tied embedding N(0, ``EMBEDDING_STD``), the projections
  into the residual stream N(0, ``OUT_STD``), the attention's query and
  key projections N(0, ``QK_STD``), every other weight N(0,
  ``LINEAR_STD``).
- ``build``: the port's ``GraniteHybridLM`` made on the meta device, each
  weight drawn on the card from the seed and its name, in float32, then
  rounded to the configuration's dtype, and held by the model as drawn.
- ``reference_weight``: the same tensors drawn again for the plain
  reference, one at a time, upcast to float32.
- ``k1_work``, ``request_flops``, ``decode_bytes``: K1's work in a
  request's prefill, the analytic FLOPs of a generation request and the
  bytes a decode step must move, from the configuration alone (whatever
  implements them).

Beside ``programs.py`` and ``jamba_program.py``, the one other module of the
benchmark that imports the program (``vivim_tpu_torch``), inside ``build``.
"""

from __future__ import annotations

import math

import torch

from perfbench import traffic, weights, work
from perfbench.jamba_program import DTYPES
from perfbench.reference import granite as ref

# the seeded init's stds (the configuration file's "assumed" gives the
# readings behind them, on the H100): the projections that read the normed
# stream (in_proj, q/k/v, the router, the experts' and the shared expert's
# input_linear) N(0, LINEAR_STD), transformers' initializer_range; those
# that write into the residual stream (out_proj, o_proj, the output_linear
# weights) N(0, OUT_STD), so that the layers and not the embedding (times
# 12) carry the residual stream: at 0.02 the tied head put each token's own
# logit near 59, 54 above the next, every served token repeated its input
# and the bf16 rounding of that one logit set the check's readings; the tied
# embedding N(0, EMBEDDING_STD): the served logits h . E / 16, h of unit RMS
# after the final norm, then have a std of 4096 ** 0.5 * 0.25 / 16 = 1; the
# query and key projections N(0, QK_STD), so that attention is peaked over
# the 4096 keys: a score q . k / 128 has a std of 128 ** 0.5 * (64 s) ** 2 /
# 128 = 362 s ** 2 for a std s, 8.1 at 0.15 and 0.14 at 0.02 (near uniform:
# the attention layer's output, a mean of 4096 values, was too small for a
# K/V position that stops advancing to move the logits past the check)
LINEAR_STD = 0.02
EMBEDDING_STD = 0.25
OUT_STD = 1.0
QK_STD = 0.15
OUT = ("out_proj.weight", "o_proj.weight", "output_linear.weight")
QK = ("q_proj.weight", "k_proj.weight")


def init(cfg, name, shape, gen, device):
    """Parameter ``name`` of ``shape``, float32, from ``gen``."""
    rand = lambda: torch.rand(shape, generator=gen, device=device)
    if name.endswith("mamba.A_log"):
        return torch.log(1 + 15 * rand())
    if name.endswith("mamba.dt_bias"):
        lo, hi = math.log(1e-3), math.log(0.1)
        dt = torch.exp(lo + (hi - lo) * rand()).clamp(min=1e-4)
        return dt + torch.log(-torch.expm1(-dt))
    if name.endswith("mamba.D") or "norm." in name:
        return torch.ones(shape, device=device)
    if ".conv1d." in name:   # weight and bias U(+-width^-0.5)
        return (rand() * 2 - 1) * cfg["mamba_d_conv"] ** -0.5
    std = (EMBEDDING_STD if name.endswith("embed_tokens.weight")
           else OUT_STD if name.endswith(OUT)
           else QK_STD if name.endswith(QK) else LINEAR_STD)
    return torch.randn(shape, generator=gen, device=device) * std


def draw(cfg, name, shape, seed, device):
    """Parameter ``name`` from its own stream of ``seed``, with the init of
    its kind, in the configuration's dtype."""
    gen = weights.generator(traffic.sub_seed(seed, "weights", name), device)
    return init(cfg, name, tuple(shape), gen, device).to(
        DTYPES[cfg["dtype"]])


def reference_weight(cfg, seed, device):
    """``weight(name)`` for ``reference.granite.forward``: the program's
    tensor drawn again, upcast to float32."""
    shapes = ref.names(cfg)
    return lambda name: draw(cfg, name, shapes[name], seed, device).float()


def build(cfg, seed, device):
    """(the port's ``GraniteHybridLM`` on ``device`` holding the seeded
    weights, its ``lm.lm_params`` dict)."""
    from vivim_tpu_torch.nn import granite, lm

    gcfg = granite.config_from_granite_json(cfg)
    lm.check_kernel_config(gcfg, device)
    with torch.device("meta"):
        model = granite.GraniteHybridLM(gcfg)
    sd = {n: draw(cfg, n, s, seed, device) for n, s in ref.names(cfg).items()}
    if gcfg.tie_word_embeddings:
        sd["lm_head.weight"] = sd["model.embed_tokens.weight"]
    model.load_state_dict(sd, strict=True, assign=True)
    if gcfg.tie_word_embeddings:
        model.lm_head.weight = model.model.embed_tokens.weight
    return model.eval(), lm.lm_params(model)


def _layers(cfg):
    """(Mamba-2 layers, attention layers)."""
    kinds = ref.layer_types(cfg)
    n_attn = sum(k == "attention" for k in kinds)
    return len(kinds) - n_attn, n_attn


def k1_work(cfg, batch, length, elem):
    """K1's work (bytes, fp32 operations, exps) over a prefill of (batch,
    length): one call a Mamba-2 layer at (batch, length, d_inner), its B and
    C the groups', and no z."""
    _, d, n, g, *_ = ref.dims(cfg)
    nbytes, ops, exps = work.scan_work(batch, length, d, n, elem)
    # B and C of every group, and no z to read
    nbytes += batch * length * (2 * (g - 1) * n - d) * elem
    return work.total([(nbytes, ops, exps)] * _layers(cfg)[0])


def request_flops(cfg, batch, prompt, new):
    """The FLOPs a generation request needs: the prefill of ``prompt``
    tokens and ``new`` decode steps of one token (the last step's too), per
    row: every projection, the conv, the routed experts only (top-k of each
    token, and the router), the shared expert, each query's scores and
    values over the keys before it, the head where logits are made (the
    prompt's last position and each step), and the scan's operations
    (``work.scan_work``)."""
    m, d, n, g, heads, _, w, ha, kv, hd, f, fs, e, v = ref.dims(cfg)
    n_mamba, n_attn = _layers(cfg)
    cd = d + 2 * g * n
    k = cfg["num_experts_per_tok"]
    per_token = 2 * (n_mamba * (m * (d + cd + heads) + d * m + w * cd)
                     + n_attn * (2 * m * ha * hd + 2 * m * kv * hd)
                     + (n_mamba + n_attn) * (k * 3 * m * f + m * e
                                             + 3 * m * fs))
    tokens = prompt + new
    pairs = prompt * (prompt + 1) // 2 + sum(prompt + t + 1
                                             for t in range(new))
    attn = n_attn * 4 * ha * hd * pairs
    head = 2 * m * v * (1 + new)
    scan = n_mamba * work.scan_work(1, tokens, d, n, 4)[1]
    return batch * (tokens * per_token + attn + head + scan)


def decode_bytes(cfg, batch, prompt, new, experts_per_step, elem):
    """The bytes a decode step must move, on average over the ``new``
    steps: every weight outside the routed experts once (the shared experts
    and routers among them; a tied embedding whole, as the head reads it,
    else the head whole and the batch's rows of the embedding),
    ``experts_per_step`` routed experts' weights (distinct experts chosen,
    summed over the layers), each attention layer's filled K/V positions
    read and one written, and each Mamba-2 layer's conv state (in ``elem``
    bytes) and fp32 ssm state read and written."""
    m, d, n, g, _, _, w, _, kv, hd, f, *_ = ref.dims(cfg)
    n_mamba, n_attn = _layers(cfg)
    tied = cfg.get("tie_word_embeddings", False)
    shared = sum(math.prod(s) for name, s in ref.names(cfg).items()
                 if "block_sparse_moe.input_linear" not in name
                 and "block_sparse_moe.output_linear" not in name
                 and (tied or name != "model.embed_tokens.weight"))
    if not tied:
        shared += batch * m
    experts = experts_per_step * 3 * m * f
    filled = prompt + (new + 1) / 2
    cache = n_attn * batch * 2 * kv * hd * (filled + 1)
    states = n_mamba * 2 * batch * ((d + 2 * g * n) * w * elem + d * n * 4)
    return (shared + experts + cache) * elem + states
