"""Mamba language model and generation.

Port of the JAX package's ``nn/lm.py``, the reference's MixerModel +
MambaLMHeadModel (mixer_seq_simple.py:83-233) and its generation loop
(utils/generation.py:39-200):

- ``MambaLM``: embedding -> n x [pre-norm, single-direction Mamba mixer
  (``MambaV3(bimamba_type="none")``), residual] -> ``norm_f`` -> tied lm
  head, over the vocabulary padded to ``pad_vocab_multiple``.  Its
  state_dict keys are the reference's (``backbone.embedding.weight``,
  ``backbone.layers.{i}.mixer.*``, ``backbone.layers.{i}.norm.*``,
  ``backbone.norm_f.*``, ``lm_head.weight`` tied to the embedding), so a
  ``state-spaces/mamba-*`` ``pytorch_model.bin`` loads into it strictly.
- ``forward_functional`` / ``generate`` run from a flat parameter dict
  (``lm_params``: the model's own tensors, a bf16 copy, or an int8 dict of
  ``nn.quant.quantize_lm_params``): the prompt through
  ``streaming.mamba_prefill`` (K1 on the card, one launch per layer), then
  every token through ``streaming.mamba_step`` (two kernels on the card
  that step the conv and ssm states in place) with temperature / top-k /
  top-p sampling on an explicit ``torch.Generator``.
- ``DecodeGraph``: ``decode_step`` over static token, state and logits
  buffers, captured once as a CUDA graph on the card and replayed for
  every token (the reference's CUDA-graph decode cache,
  utils/generation.py:256-377; the JAX package jits its decode loop
  instead).  The model keeps one, keyed on the batch, the compute dtype
  and the parameters' tensors; on the CPU the same buffers run eagerly.

The same functions serve a hybrid LM (``nn/jamba.py``, ``nn/granite.py``,
``nn/falcon_h1.py``): its model splits its own dict into ``Layer``s
(``split_params``), each a Mamba mixer, a Mamba-2 mixer
(``streaming.Mamba2``), a grouped-query attention layer
(``nn/attention.py``) or both of the last two side by side on one input
(``Parallel``, Falcon-H1's) after its pre-norm, then optionally a
feed-forward after its own pre-norm (a SwiGLU MLP or the dropless MoE block
of ``nn/moe.py``).  Each layer carries one record of decode state, a tuple
in one list: a Mamba layer its (conv state, ssm state), an attention layer
its (K/V cache, position), a parallel layer its (conv state, ssm state, K/V
cache, position); prefill, decode and the decode graph hold every kind side
by side.  ``LMParts`` carries the µP scalars of such a model (Granite's:
the embeddings times ``embedding_multiplier``, each mixer's and
feed-forward's output times ``residual_multiplier`` before its residual
add, the logits over ``logits_scaling``; Falcon-H1's: the logits times
``lm_head_multiplier``), the attention's softmax scale and its rotary
positions (``rope``, Falcon-H1's); at their defaults (1, 1, 1, 1, None:
1/sqrt(head_dim), None: no positions) nothing is multiplied or rotated.

The token loop runs every one of ``max_new_tokens`` steps whatever eos
says, and keeps ``done`` on the device: nothing in a step waits for the
host.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import math

import torch
from torch import nn

from vivim_tpu_torch.kernels import selective_scan as _scan
from vivim_tpu_torch.nn import attention, quant, streaming
from vivim_tpu_torch.nn.mamba import MambaV3
from vivim_tpu_torch.utils import cuda_graphs
from vivim_tpu_torch.utils.profiling import span

_log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class MambaLMConfig:
    vocab_size: int
    d_model: int = 768
    n_layer: int = 24
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    pad_vocab_multiple: int = 8
    initializer_range: float = 0.02
    # MixerModel's norm options (mixer_seq_simple.py:24-27,90-94); the
    # state-spaces/mamba-* checkpoints set rms_norm and residual_in_fp32.
    # The reference's fused_add_norm is a kernel fusion with the same math.
    rms_norm: bool = False
    norm_epsilon: float = 1e-5
    residual_in_fp32: bool = False

    @property
    def padded_vocab(self):
        m = self.pad_vocab_multiple
        return ((self.vocab_size + m - 1) // m) * m


def config_from_mamba_json(d: dict, **overrides) -> MambaLMConfig:
    """``MambaLMConfig`` from a mamba snapshot's ``config.json`` dict, the
    keys ``MambaLMHeadModel.from_pretrained`` reads (utils/hf.py:9-13,
    mixer_seq_simple.py:173-191)."""
    ssm = d.get("ssm_cfg") or {}
    kw = dict(
        vocab_size=d["vocab_size"], d_model=d["d_model"],
        n_layer=d["n_layer"],
        d_state=ssm.get("d_state", 16), d_conv=ssm.get("d_conv", 4),
        expand=ssm.get("expand", 2),
        pad_vocab_multiple=d.get("pad_vocab_size_multiple", 8),
        rms_norm=d.get("rms_norm", False),
        norm_epsilon=d.get("norm_epsilon", 1e-5),
        residual_in_fp32=d.get("residual_in_fp32", False),
    )
    kw.update(overrides)
    return MambaLMConfig(**kw)


def check_kernel_config(cfg, device, implementation=None):
    """Raise for a config the card's kernels cannot run: both CUDA
    selective-scan kernels take d_state 1 to ``MAX_DSTATE`` = 256, as
    mamba_ssm's CUDA scan does.  The CPU and ``implementation="ref"`` take
    any d_state."""
    if torch.device(device).type == "cuda" and implementation != "ref":
        try:
            _scan.check_dstate(cfg.d_state)
        except ValueError as e:
            raise ValueError(f"{e}; run this config with "
                             "implementation='ref' or on the CPU") from None


def layer_norm(np_, h, eps=1e-5):
    """LayerNorm from a ``{"weight", "bias"}`` dict (eps 1e-5, the
    reference's norm_epsilon; the SegFormer norms use 1e-6)."""
    mean = h.mean(-1, keepdim=True)
    var = ((h - mean) ** 2).mean(-1, keepdim=True)
    return (h - mean) * torch.rsqrt(var + eps) * np_["weight"] + np_["bias"]


def rms_norm(np_, h, eps=1e-5):
    """RMSNorm from a ``{"weight"}`` dict: x * rsqrt(mean(x^2) + eps) *
    weight, no bias (ops/triton/layernorm.py:35-48)."""
    return h * torch.rsqrt((h * h).mean(-1, keepdim=True) + eps) \
        * np_["weight"]


def norm_fn_for(cfg):
    """The functional norm of ``MambaLM``'s config."""
    fn = rms_norm if getattr(cfg, "rms_norm", False) else layer_norm
    return functools.partial(fn, eps=getattr(cfg, "norm_epsilon", 1e-5))


class Norm(nn.Module):
    """LayerNorm (``weight``, ``bias``) or RMSNorm (``weight``) over the
    last axis, computed as ``layer_norm`` / ``rms_norm``: a norm of an fp32
    residual with bf16 weights gives fp32."""

    def __init__(self, d_model, eps=1e-5, rms=False):
        super().__init__()
        self.eps, self.rms = eps, rms
        self.weight = nn.Parameter(torch.ones(d_model))
        if not rms:
            self.bias = nn.Parameter(torch.zeros(d_model))

    def forward(self, h):
        if self.rms:
            return rms_norm({"weight": self.weight}, h, self.eps)
        return layer_norm({"weight": self.weight, "bias": self.bias}, h,
                          self.eps)


class Block(nn.Module):
    def __init__(self, cfg, scan_implementation=None):
        super().__init__()
        self.norm = Norm(cfg.d_model, cfg.norm_epsilon, cfg.rms_norm)
        self.mixer = MambaV3(cfg.d_model, d_state=cfg.d_state,
                             d_conv=cfg.d_conv, expand=cfg.expand,
                             bimamba_type="none",
                             scan_implementation=scan_implementation)


class MixerModel(nn.Module):
    def __init__(self, cfg, scan_implementation=None):
        super().__init__()
        self.embedding = nn.Embedding(cfg.padded_vocab, cfg.d_model)
        self.layers = nn.ModuleList(Block(cfg, scan_implementation)
                                    for _ in range(cfg.n_layer))
        self.norm_f = Norm(cfg.d_model, cfg.norm_epsilon, cfg.rms_norm)


class MambaLM(nn.Module):
    """tokens (B, L) -> logits (B, L, padded_vocab)."""

    def __init__(self, cfg: MambaLMConfig, scan_implementation=None):
        super().__init__()
        self.cfg = cfg
        self.scan_implementation = scan_implementation
        self.backbone = MixerModel(cfg, scan_implementation)
        self.lm_head = nn.Linear(cfg.d_model, cfg.padded_vocab, bias=False)
        self.lm_head.weight = self.backbone.embedding.weight
        # generate's DecodeGraph (the reference's model._decoding_cache)
        self._decoding_cache = None

    @torch.no_grad()
    def init_parameters(self, gen):
        """The embedding (and so the tied head) ~ N(0, initializer_range);
        ``nn.layers.init_weights`` gives the rest their schemes."""
        nn.init.normal_(self.backbone.embedding.weight,
                        std=self.cfg.initializer_range, generator=gen)

    def forward(self, tokens):
        cfg = self.cfg
        check_kernel_config(cfg, tokens.device, self.scan_implementation)
        h = self.backbone.embedding.weight[tokens]
        dtype = h.dtype
        if cfg.residual_in_fp32:
            # the residual stream in fp32, the mixers in the compute dtype
            # (Block.forward, mamba_simple.py:480-489)
            h = h.float()
        for layer in self.backbone.layers:
            res = h
            out = layer.mixer(layer.norm(h).to(dtype))
            h = res + out.to(res.dtype)
        return self.lm_head(self.backbone.norm_f(h).to(dtype))


def lm_params(model: MambaLM) -> dict:
    """The model's parameters as a flat dict under their reference names,
    the tied head once (as ``backbone.embedding.weight``): what
    ``forward_functional`` and ``generate`` take."""
    return {k: v.detach() for k, v in model.named_parameters()}


def rescale_residual_projections(params, n_layer, n_residuals_per_layer=1):
    """GPT-2 depth rescaling of the out_proj weights
    (mixer_seq_simple.py:64-80): a new dict."""
    scale = 1.0 / math.sqrt(n_residuals_per_layer * n_layer)
    return {k: v * scale if k.endswith("out_proj.weight") else v
            for k, v in params.items()}


def sub_params(params, prefix):
    """The entries of ``params`` under ``prefix``, the prefix dropped."""
    n = len(prefix)
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix)}


@dataclasses.dataclass
class Parallel:
    """A Mamba-2 mixer and grouped-query attention on one normed input x
    (transformers' ``FalconH1DecoderLayer``): ``ssm(x) * ssm_out +
    attn(x * attn_in) * attn_out``, each product in the activations'
    dtype."""

    attn: dict
    ssm: streaming.Mamba2
    attn_in: float
    attn_out: float
    ssm_out: float


@dataclasses.dataclass
class Layer:
    """One layer of a split dict: the mixer after the pre-norm ``norm``, of
    ``kind`` "mamba" (a Mamba mixer's dict), "mamba2" (a
    ``streaming.Mamba2``), "attention" (a grouped-query attention layer's
    dict) or "parallel" (a ``Parallel``); then, where ``ff`` is given, a
    feed-forward after the pre-norm ``ff_norm``: ``ff(x)`` over a sequence,
    ``ff_step(x)`` over one token inside a captured decode step."""

    mixer: object
    norm: dict
    kind: str = "mamba"
    ff_norm: dict | None = None
    ff: object = None
    ff_step: object = None


@dataclasses.dataclass
class LMParts:
    """A flat parameter dict split once per call into what the forwards
    read (per-token code must not walk the dict)."""

    emb: object
    layers: list          # [Layer] per layer
    norm_f: dict
    apply_norm: object
    dtype: torch.dtype
    residual_in_fp32: bool
    implementation: str | None
    head: object = None   # an untied head's weight; None: the embedding's
    n_heads: int = 0      # the attention layers' query and key/value heads
    n_kv_heads: int = 0
    ssm_norm_eps: float = 1e-6   # the dt / B / C norms' (where a mixer has)
    logits_dtype: torch.dtype | None = None   # None: the head's
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    lm_head_multiplier: float = 1.0
    attn_scale: float | None = None   # None: head_dim ** -0.5
    rope: attention.Rope | None = None   # None: no positions

    def embed(self, tokens):
        h = self.residual(quant.embed_lookup(self.emb, tokens,
                                             dtype=self.dtype))
        m = self.embedding_multiplier
        return h if m == 1.0 else h * m

    def residual(self, h):
        return h.float() if self.residual_in_fp32 else h

    def add(self, h, out):
        """The residual ``h`` plus a block's ``out`` times the residual
        multiplier (in out's dtype, as transformers' Granite)."""
        m = self.residual_multiplier
        return h + (out if m == 1.0 else out * m).to(h.dtype)

    def logits(self, h):
        out = quant.lm_head(h, self.emb if self.head is None else self.head)
        if self.logits_dtype is not None:
            out = out.to(self.logits_dtype)
        if self.logits_scaling != 1.0:
            out = out / self.logits_scaling
        return scaled(out, self.lm_head_multiplier)

    def attn_args(self):
        """The attention calls' trailing arguments: the scale, then the
        rope where the model has one."""
        return ((self.attn_scale,) if self.rope is None
                else (self.attn_scale, self.rope))


def scaled(t, m):
    """``t`` times the multiplier ``m`` (``t`` itself at 1)."""
    return t if m == 1.0 else t * m


def split_params(model: MambaLM, params) -> LMParts:
    if hasattr(model, "split_params"):   # a hybrid LM splits its own dict
        return model.split_params(params)
    return parts_for(model.cfg, params, model.scan_implementation)


def parts_for(cfg: MambaLMConfig, params, implementation=None) -> LMParts:
    """``split_params`` from a config: the tensor-parallel forward's (its
    mixers' leaves are this rank's split of them)."""
    return LMParts(
        emb=params["backbone.embedding.weight"],
        layers=[Layer(sub_params(params, f"backbone.layers.{i}.mixer."),
                      sub_params(params, f"backbone.layers.{i}.norm."))
                for i in range(cfg.n_layer)],
        norm_f=sub_params(params, "backbone.norm_f."),
        apply_norm=norm_fn_for(cfg), dtype=quant.compute_dtype(params),
        residual_in_fp32=cfg.residual_in_fp32,
        implementation=implementation)


def forward_functional(model: MambaLM, params, tokens) -> torch.Tensor:
    """Full-sequence logits through the prefill path ``generate`` uses;
    unlike ``model(tokens)`` it takes int8 dicts, so scoring runs the same
    weights decode serves.  For a float dict it computes what ``model``
    does: embed -> n x [norm + mixer prefill] -> norm_f -> tied head, and
    is differentiable in the dict's tensors (K1-training and K2 on the
    card); a caller that wants no graph runs it under ``no_grad``."""
    check_kernel_config(model.cfg, tokens.device, model.scan_implementation)
    return forward_parts(split_params(model, params), tokens)


def forward_parts(parts: LMParts, tokens, mixer_prefill=None):
    """Full-sequence logits (B, L, V) of split parameters, each mixer
    through ``mixer_prefill(mixer params, x)`` (``mamba_prefill`` when
    None; the hook a tensor-parallel forward uses)."""
    h, _ = _backbone(parts, tokens, mixer_prefill)
    return parts.logits(h)


def filter_logits(logits, temperature, top_k, top_p):
    """Temperature, then top-k, then top-p (generation.py:39-89): the
    logits with every token sampling may not draw set to -inf."""
    logits = logits / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep the smallest set with cumulative probability >= top_p
        idx = (cum < top_p).sum(-1, keepdim=True).clamp(
            max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, idx)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def _sample_logits(generator, logits, temperature, top_k, top_p):
    """One token per row: argmax at temperature 0, else a draw from the
    filtered logits (Gumbel-max on ``generator``'s exponentials: no host
    sync)."""
    if temperature == 0.0:
        return logits.argmax(-1)
    filtered = filter_logits(logits, temperature, top_k, top_p).float()
    # an exponential of exactly 0 would lift a filtered -inf to NaN
    e = torch.empty_like(filtered).exponential_(generator=generator)
    return (filtered - e.clamp_(min=torch.finfo(e.dtype).tiny).log()
            ).argmax(-1)


def _feed_forward(parts: LMParts, layer: Layer, h, ff):
    """``h`` plus the layer's feed-forward ``ff`` (``layer.ff`` or
    ``layer.ff_step``) of its pre-normed ``h``."""
    x = parts.apply_norm(layer.ff_norm, h).to(parts.dtype)
    return parts.add(h, ff(x))


def _mixer_prefill(parts: LMParts, layer: Layer, x, mixer_prefill,
                   max_len):
    """(out, the layer's decode state) of its mixer over a sequence."""
    if layer.kind == "attention":
        with span("lm.attn"):
            out, *state = attention.gqa_prefill(
                layer.mixer, x, parts.n_heads, parts.n_kv_heads, max_len,
                *parts.attn_args())
    elif layer.kind == "mamba2":
        out, *state = streaming.mamba2_prefill(layer.mixer, x,
                                               parts.implementation)
    elif layer.kind == "parallel":
        p = layer.mixer
        ssm, *state = streaming.mamba2_prefill(p.ssm, x, parts.implementation)
        with span("lm.attn"):
            attn, *kv = attention.gqa_prefill(
                p.attn, scaled(x, p.attn_in), parts.n_heads,
                parts.n_kv_heads, max_len, *parts.attn_args())
        out = scaled(ssm, p.ssm_out) + scaled(attn, p.attn_out)
        state += kv
    else:
        out, *state = mixer_prefill(layer.mixer, x)
    return out, tuple(state)


def _mixer_step(parts: LMParts, layer: Layer, x, state, mixer_step):
    """(out, the layer's state) of its mixer over one token, the state
    stepped in place."""
    if layer.kind == "attention":
        out, *state = attention.gqa_step(layer.mixer, x, *state,
                                         parts.n_heads, parts.n_kv_heads,
                                         *parts.attn_args())
    elif layer.kind == "mamba2":
        out, *state = streaming.mamba2_step(layer.mixer, x, *state)
    elif layer.kind == "parallel":
        p = layer.mixer
        ssm, *ssm_state = streaming.mamba2_step(p.ssm, x, *state[:2])
        attn, *kv = attention.gqa_step(
            p.attn, scaled(x, p.attn_in), *state[2:], parts.n_heads,
            parts.n_kv_heads, *parts.attn_args())
        out = scaled(ssm, p.ssm_out) + scaled(attn, p.attn_out)
        state = ssm_state + kv
    else:
        out, *state = mixer_step(layer.mixer, x, *state)
    return out, tuple(state)


def _backbone(parts: LMParts, tokens, mixer_prefill=None, max_len=None):
    """The tokens (B, L) through every layer and ``norm_f``: (hidden states
    (B, L, d_model), the layers' decode states, one record a layer; an
    attention layer's K/V cache holds ``max_len`` positions, L when
    None)."""
    mixer_prefill = mixer_prefill or functools.partial(
        streaming.mamba_prefill, implementation=parts.implementation,
        norm_eps=parts.ssm_norm_eps)
    h = parts.embed(tokens)
    states = []
    for layer in parts.layers:
        x = parts.apply_norm(layer.norm, h).to(parts.dtype)
        out, state = _mixer_prefill(parts, layer, x, mixer_prefill, max_len)
        h = parts.add(h, out)
        if layer.ff is not None:
            h = _feed_forward(parts, layer, h, layer.ff)
        states.append(state)
    h = parts.apply_norm(parts.norm_f, h).to(parts.dtype)
    return h, states


def prefill(parts: LMParts, tokens, mixer_prefill=None, max_len=None):
    """The prompt (B, L0) through every layer: (last logits (B, V), the
    layers' decode states, one record a layer); ``max_len``: the positions
    an attention layer's K/V cache holds (the prompt and every token decode
    will add)."""
    h, states = _backbone(parts, tokens, mixer_prefill, max_len)
    return parts.logits(h[:, -1]), states


def decode_step(parts: LMParts, token, states, mixer_step=None):
    """One token (B,) through every layer from the carried states, each
    stepped in place: (logits (B, V), states), a list of records of the
    same tensors.  A Mamba layer's record is its (window, ssm state), an
    attention layer's its (K/V cache, position), a parallel layer's its
    (window, ssm state, K/V cache, position)."""
    mixer_step = mixer_step or functools.partial(
        streaming.mamba_step, norm_eps=parts.ssm_norm_eps)
    h = parts.embed(token)
    new_states = []
    for layer, state in zip(parts.layers, states):
        x = parts.apply_norm(layer.norm, h).to(parts.dtype)
        out, state = _mixer_step(parts, layer, x, state, mixer_step)
        h = parts.add(h, out)
        if layer.ff_step is not None:
            h = _feed_forward(parts, layer, h, layer.ff_step)
        new_states.append(state)
    h = parts.apply_norm(parts.norm_f, h).to(parts.dtype)
    return parts.logits(h), new_states


class DecodeGraph:
    """``decode_step`` over static buffers: a token (B,), each layer's
    record of state (a Mamba layer's conv state (B, W, d_inner) and fp32
    ssm state (B, d_inner, N); an attention layer's K/V cache (B, 2, n_kv,
    max_len, head_dim) and int64 position (1,); a parallel layer's four),
    and the logits (B, V).  Each call steps the static states in place
    (``decode_step`` writes every state where it lies) and returns the
    static logits, which the next call overwrites.  On the card the step is
    one CUDA graph (``cuda_graphs.capture``), warmed up and captured here on
    zero states, before ``start`` loads any live state; on the CPU it runs
    eagerly."""

    def __init__(self, parts: LMParts, params, states):
        self.key = decode_key(params, states)
        self.parts = parts   # holds the weights the graph reads alive
        self.states = [tuple(torch.zeros_like(t) for t in s) for s in states]
        first = states[0][0]
        token = torch.zeros(first.shape[0], dtype=torch.long,
                            device=first.device)
        self.step = (cuda_graphs.capture(self._step, (token,))
                     if token.is_cuda else self._step)

    def _step(self, token):
        return decode_step(self.parts, token, self.states)[0]

    def start(self, states):
        """Load the prefill's states; returns the step (token -> logits)."""
        for dst, src in zip(self.states, states):
            for d, s in zip(dst, src):
                d.copy_(s)
        return self.step


def decode_key(params, states):
    """A decode graph's key: the parameters' tensors and the states'
    shapes and dtypes (the batch and the compute dtype among them)."""
    return cuda_graphs.tensors_key(params), tuple(
        cuda_graphs.signature(t) for s in states for t in s)


def decode_graph(model: MambaLM, parts, params, states):
    """The model's ``DecodeGraph`` for these parameters and states: the
    cached one when its key matches, else a new one that replaces it."""
    cached = model._decoding_cache
    with span("graph.key"):
        stale = cached is None or cached.key != decode_key(params, states)
    if stale:
        model._decoding_cache = None   # its graph's memory goes first
        model._decoding_cache = DecodeGraph(parts, params, states)
    return model._decoding_cache


@torch.no_grad()
def generate(model: MambaLM, params, tokens, max_new_tokens, generator=None,
             temperature=1.0, top_k=0, top_p=1.0, eos_token_id=None,
             mixer_prefill=None, mixer_step=None, teacher_outputs=None,
             output_scores=False):
    """Prefill, then ``max_new_tokens`` decode steps.

    tokens (B, L0) prompt on the parameters' device.  Returns (B, L0 +
    max_new_tokens) tokens, or ``(tokens, scores)`` with scores (B,
    max_new_tokens, V) when ``output_scores``: ``scores[:, t]`` are the
    logits that produced token t (generation.py:199-223).

    ``generator``: the ``torch.Generator`` (on the parameters' device) the
    draws come from; a fresh one seeded 0 when None.  ``teacher_outputs``
    (B, L_teacher): positions below L_teacher of the whole sequence (prompt
    included) are taken from it instead of drawn (generation.py:101,
    116-117,164-168).  After ``eos_token_id`` a row emits only eos.
    ``mixer_prefill(mixer_params, x)`` / ``mixer_step(mixer_params, x,
    conv_state, ssm_state)`` replace the per-mixer prefill and step (the
    hook a tensor-parallel decode uses); with either hook the tokens run
    an eager loop of ``decode_step``, else the model's ``DecodeGraph``.

    Spans (``utils/profiling.py::span``): ``lm.generate`` holds the
    prefill's ``lm.forward`` (and in it each Mamba mixer's recurrence in
    ``lm.ssm``, each attention layer's or parallel layer's attention branch
    in ``lm.attn`` and each MoE block's ``lm.moe``), each token's
    ``lm.draw`` (the draw,
    the eos mask, the score's copy), the decode graph's ``graph.key`` and,
    on the card, each token's ``graph.replay``.
    """
    with span("lm.generate"):
        dev = tokens.device
        check_kernel_config(model.cfg, dev, model.scan_implementation)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        parts = split_params(model, params)
        with span("lm.forward"):
            logits, states = prefill(parts, tokens, mixer_prefill,
                                     tokens.shape[1] + max_new_tokens)
        if mixer_prefill is None and mixer_step is None:
            step = decode_graph(model, parts, params, states).start(states)
        else:
            # a tensor-parallel decode over gloo copies its collectives
            # through the host, which a CUDA graph cannot capture
            _log.info("generate: mixer hooks given -> eager decode loop")

            def step(token):
                nonlocal states
                out, states = decode_step(parts, token, states, mixer_step)
                return out

        prompt_len = tokens.shape[1]
        tlen = teacher_outputs.shape[1] if teacher_outputs is not None else 0
        done = torch.zeros(tokens.shape[0], dtype=torch.bool, device=dev)
        new_tokens, scores = [], []
        for t in range(max_new_tokens):
            with span("lm.draw"):
                nxt = _sample_logits(generator, logits, temperature, top_k,
                                     top_p)
                if prompt_len + t < tlen:
                    nxt = teacher_outputs[:, prompt_len + t].to(nxt.dtype)
                if eos_token_id is not None:
                    nxt = torch.where(done, eos_token_id, nxt)
                    done = done | (nxt == eos_token_id)
                new_tokens.append(nxt)
                if output_scores:
                    scores.append(logits.clone())   # the graph reuses them
            logits = step(nxt)
        full = torch.cat([tokens.long()]
                         + [t[:, None] for t in new_tokens], dim=1)
        if output_scores:
            b, v = logits.shape
            return full, (torch.stack(scores, 1) if scores
                          else logits.new_zeros(b, 0, v))
        return full
