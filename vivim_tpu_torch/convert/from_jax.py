"""Weights between the JAX package, reference checkpoints and the port.

The port's state_dict keys are the reference PyTorch Vivim's, so a
reference Lightning checkpoint loads into it after
``strip_lightning_prefix``, and a port ``state_dict()`` is a reference
checkpoint.  ``vivim_state_dict_from_jax`` / ``mamba_state_dict_from_jax``
take the JAX package's variables (as numpy arrays) to that layout; they are
the inverse of the JAX package's ``vivim_params_from_torch`` /
``mamba_params_from_torch`` (flax Dense kernels (in, out) -> torch (out,
in); conv kernels HWIO -> OIHW, DHWIO -> OIDHW; LayerNorm scale -> weight).
``mamba_lm_state_dict_from_jax`` does the same for the Mamba LM, the inverse
of the JAX package's ``mamba_lm_params_from_torch``;
``moe_lm_state_dict_from_jax`` for the MoE-Mamba LM (whose names are the JAX
ones) and ``segformer_state_dict_from_jax`` for the SegFormer model (HF's
names).
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x):
    return torch.from_numpy(np.array(x, np.float32, copy=True))


def _linear(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(p["kernel"]),
                                             (3, 2, 0, 1)))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv3d(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(p["kernel"]),
                                             (4, 3, 0, 1, 2)))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _ln(sd, prefix, p):
    """LayerNorm {scale, bias} -> {weight, bias}; an RMSNorm {scale} ->
    {weight}."""
    sd[f"{prefix}.weight"] = _t(p["scale"])
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def mamba_state_dict_from_jax(params, prefix=""):
    """JAX ``MambaV3`` params -> reference Mamba keys under ``prefix``
    (conv1d{s} kernels (width, d) -> (d, 1, width); projections are
    already (out, in))."""
    pre = f"{prefix}." if prefix else ""
    sd = {}
    for name in ("in_proj", "out_proj"):
        sd[f"{pre}{name}.weight"] = _t(params[f"{name}_kernel"])
        if f"{name}_bias" in params:
            sd[f"{pre}{name}.bias"] = _t(params[f"{name}_bias"])
    for s in ("", "_b", "_s"):
        if f"A{s}_log" not in params:
            continue
        sd[f"{pre}conv1d{s}.weight"] = _t(
            np.asarray(params[f"conv1d{s}_kernel"]).T[:, None, :])
        if f"conv1d{s}_bias" in params:
            sd[f"{pre}conv1d{s}.bias"] = _t(params[f"conv1d{s}_bias"])
        sd[f"{pre}x_proj{s}.weight"] = _t(params[f"x_proj{s}_kernel"])
        sd[f"{pre}dt_proj{s}.weight"] = _t(params[f"dt_proj{s}_kernel"])
        sd[f"{pre}dt_proj{s}.bias"] = _t(params[f"dt_proj{s}_bias"])
        sd[f"{pre}A{s}_log"] = _t(params[f"A{s}_log"])
        sd[f"{pre}D{s}"] = _t(params[f"D{s}"])
    return sd


def mamba_lm_state_dict_from_jax(params, n_layer):
    """JAX ``MambaLM`` params -> the reference ``MambaLMHeadModel`` keys
    (``nn.lm.MambaLM``'s): the embedding, per layer the mixer and its norm
    (LayerNorm or RMSNorm), ``norm_f``, and ``lm_head.weight`` tied to the
    embedding (the same tensor)."""
    p = params.get("params", params)
    sd = {"backbone.embedding.weight": _t(p["embedding"])}
    for i in range(n_layer):
        sd.update(mamba_state_dict_from_jax(p[f"mixer_{i}"],
                                            f"backbone.layers.{i}.mixer"))
        _ln(sd, f"backbone.layers.{i}.norm", p[f"norm_{i}"])
    _ln(sd, "backbone.norm_f", p["norm_f"])
    sd["lm_head.weight"] = sd["backbone.embedding.weight"]
    return sd


def moe_lm_state_dict_from_jax(params, cfg):
    """JAX ``MoEMambaLM`` params -> ``nn.moe.MoEMambaLM``'s state_dict: the
    JAX names kept (``embedding``, ``norm_{i}``, ``moe_norm_{i}``,
    ``norm_f`` with flax's scale as weight; ``moe_{i}.router_kernel`` (M,
    E), ``wi`` (E, M, F), ``wo`` (E, F, M) as they are), each ``mixer_{i}``
    under the reference Mamba keys."""
    p = params.get("params", params)
    sd = {"embedding": _t(p["embedding"])}
    for i in range(cfg.n_layer):
        _ln(sd, f"norm_{i}", p[f"norm_{i}"])
        sd.update(mamba_state_dict_from_jax(p[f"mixer_{i}"], f"mixer_{i}"))
        if cfg.has_moe(i):
            _ln(sd, f"moe_norm_{i}", p[f"moe_norm_{i}"])
            for leaf in ("router_kernel", "wi", "wo"):
                sd[f"moe_{i}.{leaf}"] = _t(p[f"moe_{i}"][leaf])
    _ln(sd, "norm_f", p["norm_f"])
    return sd


def _segformer_stage(sd, pre, st, seg, i):
    """JAX ``SegformerStage`` ``i`` params -> the HF encoder keys of that
    stage under ``pre`` (its patch embedding and layers)."""
    _conv(sd, f"{pre}.patch_embeddings.{i}.proj", st["embed"]["proj"])
    _ln(sd, f"{pre}.patch_embeddings.{i}.layer_norm", st["embed"]["norm"])
    for j in range(seg.depths[i]):
        lp = f"{pre}.block.{i}.{j}"
        ly = st[f"layer_{j}"]
        _ln(sd, f"{lp}.layer_norm_1", ly["norm1"])
        _ln(sd, f"{lp}.layer_norm_2", ly["norm2"])
        at = ly["attn"]
        for name in ("query", "key", "value"):
            _linear(sd, f"{lp}.attention.self.{name}", at[name])
        _linear(sd, f"{lp}.attention.output.dense", at["proj"])
        if seg.sr_ratios[i] > 1:
            _conv(sd, f"{lp}.attention.self.sr", at["sr"])
            _ln(sd, f"{lp}.attention.self.layer_norm", at["sr_norm"])
        _linear(sd, f"{lp}.mlp.dense1", ly["ffn"]["dense1"])
        _conv(sd, f"{lp}.mlp.dwconv.dwconv", ly["ffn"]["dwconv"])
        _linear(sd, f"{lp}.mlp.dense2", ly["ffn"]["dense2"])


def _decode_head(sd, pre, p, batch_stats, n_stages):
    """The decode head's linear_c / linear_fuse / batch_norm (with its
    running statistics) under ``pre``."""
    for i in range(n_stages):
        _linear(sd, f"{pre}.linear_c.{i}.proj", p[f"linear_c_{i}"])
    _conv(sd, f"{pre}.linear_fuse", p["linear_fuse"])
    _ln(sd, f"{pre}.batch_norm", p["batch_norm"])
    sd[f"{pre}.batch_norm.running_mean"] = _t(batch_stats["mean"])
    sd[f"{pre}.batch_norm.running_var"] = _t(batch_stats["var"])
    sd[f"{pre}.batch_norm.num_batches_tracked"] = torch.tensor(0)


def segformer_state_dict_from_jax(variables, cfg):
    """JAX ``SegformerForSemanticSegmentation`` variables ({"params",
    "batch_stats"}) -> ``nn.segformer.SegformerForSemanticSegmentation``'s
    state_dict (HF's keys; loads with ``strict=True``)."""
    sd = {}
    enc = variables["params"]["encoder"]
    pre = "segformer.encoder"
    for i in range(cfg.num_stages):
        _segformer_stage(sd, pre, enc[f"stage_{i}"], cfg, i)
        _ln(sd, f"{pre}.layer_norm.{i}", enc[f"norm_{i}"])
    head = variables["params"]["decode_head"]
    _decode_head(sd, "decode_head", head,
                 variables["batch_stats"]["decode_head"]["batch_norm"],
                 cfg.num_stages)
    _conv(sd, "decode_head.classifier", head["classifier"])
    return sd


def _mamba_layer(sd, prefix, p):
    """JAX ``MambaLayer`` params -> keys under ``prefix``."""
    _ln(sd, f"{prefix}.norm1", p["norm1"])
    _ln(sd, f"{prefix}.norm2", p["norm2"])
    sd.update(mamba_state_dict_from_jax(p["mamba"], f"{prefix}.mamba"))
    _linear(sd, f"{prefix}.mlp.fc1", p["mlp"]["fc1"])
    _conv3d(sd, f"{prefix}.mlp.dwconv.dwconv", p["mlp"]["dwconv"])
    _linear(sd, f"{prefix}.mlp.fc2", p["mlp"]["fc2"])


def vivim_state_dict_from_jax(variables, cfg):
    """JAX ``Vivim`` variables ({"params", "batch_stats"}) -> the port's
    state_dict (loads with ``strict=True``).  The per-stage SegFormer
    LayerNorms, which the JAX model does not have, get unit weights."""
    sd = {}
    seg = cfg.segformer
    enc = variables["params"]["encoder"]
    pre = "encoder.downsample_layers"
    for i in range(seg.num_stages):
        _segformer_stage(sd, pre, enc[f"stage_{i}"], seg, i)
        sd[f"{pre}.layer_norm.{i}.weight"] = torch.ones(seg.hidden_sizes[i])
        sd[f"{pre}.layer_norm.{i}.bias"] = torch.zeros(seg.hidden_sizes[i])
        for j in range(cfg.depths[i]):
            _mamba_layer(sd, f"encoder.stages.{i}.{j}.0",
                         enc[f"mamba_{i}_{j}"])
    p = variables["params"]
    _decode_head(sd, "decoder", p, variables["batch_stats"]["batch_norm"],
                 seg.num_stages)
    _conv(sd, "out", p["out"])
    if "edge_head" in p:
        _conv(sd, "edgeocr_cls_head", p["edge_head"])
    return sd


def vivim_state_dict_from_hf_segformer(sd):
    """HF ``SegformerForSemanticSegmentation`` state_dict (e.g. of
    nvidia/segformer-b3-finetuned-ade-512-512) -> the part of the port's
    Vivim state_dict the reference takes from it at construction: the
    encoder (``segformer.encoder.*`` -> ``encoder.downsample_layers.*``) and
    the decode head's linear_c / linear_fuse / batch_norm (``decode_head.*``
    -> ``decoder.*``; its classifier is dropped).  Load it with
    ``strict=False``: the Mamba layers, ``out`` and the edge head keep
    their init."""
    out = {}
    for k, v in sd.items():
        if k.startswith("segformer.encoder."):
            out["encoder.downsample_layers." + k[len("segformer.encoder."):]] = (
                torch.as_tensor(v))
        elif (k.startswith("decode_head.")
              and not k.startswith("decode_head.classifier.")):
            out["decoder." + k[len("decode_head."):]] = torch.as_tensor(v)
    return out


# the HF keys Vivim does not take: the per-stage encoder LayerNorms (the
# reference Vivim does not call them, vivim.py:211-212) and the classifier
_HF_DROPPED = ("segformer.encoder.layer_norm.", "decode_head.classifier.")
# the port's keys that keep their init under the graft: the Mamba layers,
# the output conv, the edge head, and the per-stage LayerNorms it never calls
_HF_KEPT_INIT = ("encoder.stages.", "out.", "edgeocr_cls_head.",
                 "encoder.downsample_layers.layer_norm.")


def load_torch_state_dict(path):
    """A torch state_dict from a file or an HF snapshot directory, where
    ``model.safetensors`` is taken before ``pytorch_model.bin``.  A
    ``.safetensors`` file needs the ``safetensors`` package: without it this
    raises, and never falls back to another file."""
    import os

    if os.path.isdir(path):
        st = os.path.join(path, "model.safetensors")
        bin_ = os.path.join(path, "pytorch_model.bin")
        if not os.path.exists(st) and not os.path.exists(bin_):
            raise FileNotFoundError(
                f"{path} holds neither model.safetensors nor "
                "pytorch_model.bin")
        path = st if os.path.exists(st) else bin_
    if path.endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise ImportError(
                f"{path} needs the safetensors package, which is not "
                "installed: install it, or give a pytorch_model.bin") from e
        return load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd.get("state_dict", sd)


def graft_hf_segformer(model, hf_sd):
    """Load an HF ``SegformerForSemanticSegmentation`` state_dict into the
    port's Vivim ``model`` in place, as the reference does at construction
    (vivim.py:264-267): the encoder stages and the decode head's linear_c /
    linear_fuse / batch_norm.  Raises unless the HF keys left over are
    exactly the per-stage encoder LayerNorms and the classifier, and the
    model keys left at their init exactly the Mamba layers, ``out``, the
    edge head and the per-stage LayerNorms (a snapshot of another model must
    not load as nothing).  Returns the number of tensors taken."""
    mapped = {k: v for k, v in vivim_state_dict_from_hf_segformer(hf_sd).items()
              if not k.startswith(_HF_KEPT_INIT)}
    own = model.state_dict()
    unexpected = sorted(k for k in mapped if k not in own)
    left = sorted(k for k in hf_sd if k.startswith(_HF_DROPPED))
    n_stages = model.cfg.segformer.num_stages
    want_left = sorted(
        [f"segformer.encoder.layer_norm.{i}.{w}" for i in range(n_stages)
         for w in ("weight", "bias")]
        + [f"decode_head.classifier.{w}" for w in ("weight", "bias")])
    missing = sorted(k for k in own if k not in mapped)
    want_missing = sorted(k for k in own if k.startswith(_HF_KEPT_INIT))
    if (unexpected or left != want_left or missing != want_missing
            or len(mapped) + len(left) != len(hf_sd)):
        raise ValueError(
            "not an HF SegFormer snapshot of this Vivim's encoder: keys the "
            f"model lacks {unexpected[:8]}, HF keys not taken {left[:8]} "
            f"(want {want_left[:8]}), model keys left at init "
            f"{sorted(set(missing) - set(want_missing))[:8]} beyond the "
            "Mamba layers, out and the edge head")
    model.load_state_dict(mapped, strict=False)
    return len(mapped)


def inverse_net_state_dict_from_jax(params):
    """JAX ``InverseNet`` params ({"fc0", "fc1", "fc2"}) -> the port's
    ``InverseNet`` keys (``fc.0``, ``fc.2``, ``fc.4``)."""
    sd = {}
    for i in range(3):
        _linear(sd, f"fc.{2 * i}", params[f"fc{i}"])
    return sd


def strip_lightning_prefix(sd, prefix="model."):
    """Strip the Lightning wrapper prefix from state_dict keys."""
    return {k[len(prefix):] if k.startswith(prefix) else k: v
            for k, v in sd.items()}


def reference_state_dict(obj):
    """A loaded reference Lightning checkpoint (``{"state_dict": ...}``,
    keys under ``model.``) or a port state_dict -> the port's state_dict.
    Drops ``decoder.classifier.*``: the reference's HF decode head carries
    it but never calls it."""
    sd = obj.get("state_dict", obj)
    return {k: v for k, v in strip_lightning_prefix(sd).items()
            if not k.startswith("decoder.classifier.")}
