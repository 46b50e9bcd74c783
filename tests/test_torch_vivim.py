"""Vivim eval logits of the PyTorch port against the JAX package, and the
weight round trip between the two.

The port's seeded weights (with random BatchNorm running statistics) go to
the JAX model through the JAX package's ``vivim_params_from_torch``; the
clip is numpy from a seed.  At 48 px stage 0 is a 12x12 map under a
spatial-reduction ratio of 8, so the asymmetric "SAME" padding of the
``sr`` conv is exercised.  Tolerance 1e-3, the level of
tests/test_vivim_golden.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vivim_tpu.convert.torch_to_jax import vivim_params_from_torch
from vivim_tpu.nn.vivim import Vivim as JVivim
from vivim_tpu.nn.vivim import VivimConfig as JConfig
from vivim_tpu_torch.convert.from_jax import vivim_state_dict_from_jax
from vivim_tpu_torch.nn.layers import init_weights
from vivim_tpu_torch.nn.vivim import Vivim, VivimConfig

torch.set_num_threads(1)


def _port_model(name, with_edge, seed=0):
    cfg = getattr(VivimConfig, f"{name}_test")(with_edge=with_edge)
    model = init_weights(Vivim(cfg), torch.Generator().manual_seed(seed))
    bn = model.decoder.batch_norm
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        bn.running_mean.copy_(0.1 * torch.randn(bn.num_features,
                                                generator=g))
        bn.running_var.copy_(0.5 + torch.rand(bn.num_features, generator=g))
    return model.eval(), cfg


def _numpy_sd(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("name,with_edge,jax_scan", [
    ("tiny", False, "ref"),
    ("tiny", True, "ref"),
    ("micro", False, "ref"),
    ("micro", False, None),   # JAX on its Pallas kernel (interpret mode)
])
def test_vivim_logits_match_jax(name, with_edge, jax_scan):
    model, cfg = _port_model(name, with_edge)
    jcfg = getattr(JConfig, f"{name}_test")(with_edge=with_edge,
                                             scan_implementation=jax_scan)
    variables = vivim_params_from_torch(_numpy_sd(model), jcfg)
    clip = np.random.default_rng(0).standard_normal(
        (1, 3, 48, 48, 3)).astype(np.float32)
    want = jax.jit(functools.partial(JVivim(jcfg).apply,
                                     deterministic=True))(
        variables, jnp.asarray(clip))
    with torch.no_grad():
        got = model(torch.from_numpy(clip))
    if not with_edge:
        got, want = (got,), (want,)
    assert got[0].shape == (1, 3, 48, 48, 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=1e-3)


def test_weights_round_trip_exactly():
    """port state_dict -> JAX variables (vivim_params_from_torch) -> port
    state_dict (vivim_state_dict_from_jax): every tensor equal, and the
    result loads strictly."""
    model, cfg = _port_model("tiny", True, seed=4)
    jcfg = JConfig.tiny_test(with_edge=True)
    sd = _numpy_sd(model)
    variables = jax.tree_util.tree_map(
        np.asarray, vivim_params_from_torch(sd, jcfg))
    back = vivim_state_dict_from_jax(variables, cfg)
    assert set(back) == set(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    Vivim(cfg).load_state_dict(back, strict=True)


def test_hf_segformer_snapshot_maps_like_jax():
    """An HF SegFormer state_dict (made here from a config; no network)
    grafts onto the port exactly where the JAX package's
    vivim_init_from_hf_segformer grafts it: encoder stages and the decode
    head's linear_c / linear_fuse / batch_norm."""
    transformers = pytest.importorskip("transformers")
    from vivim_tpu.convert.torch_to_jax import vivim_init_from_hf_segformer
    from vivim_tpu_torch.convert.from_jax import (
        vivim_state_dict_from_hf_segformer,
    )

    model, cfg = _port_model("tiny", False, seed=5)
    seg = cfg.segformer
    hf_cfg = transformers.SegformerConfig(
        num_channels=seg.num_channels, depths=list(seg.depths),
        hidden_sizes=list(seg.hidden_sizes),
        num_attention_heads=list(seg.num_attention_heads),
        sr_ratios=list(seg.sr_ratios), patch_sizes=list(seg.patch_sizes),
        strides=list(seg.strides), mlp_ratios=list(seg.mlp_ratios),
        decoder_hidden_size=seg.decoder_hidden_size, num_labels=3)
    torch.manual_seed(0)
    hf_sd = transformers.SegformerForSemanticSegmentation(
        hf_cfg).state_dict()
    part = vivim_state_dict_from_hf_segformer(hf_sd)
    missing, unexpected = model.load_state_dict(part, strict=False)
    assert not unexpected
    assert all(k.startswith(("encoder.stages.", "out.")) for k in missing)

    jcfg = JConfig.tiny_test()
    got = vivim_params_from_torch(_numpy_sd(model), jcfg)
    want = vivim_init_from_hf_segformer(
        {k: v.numpy() for k, v in hf_sd.items()}, jcfg)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_w) > 50
    for path, v in flat_w:
        np.testing.assert_array_equal(np.asarray(flat_g[path]),
                                      np.asarray(v), err_msg=str(path))


def test_train_mode_forward_matches_jax():
    """The train-mode decode (upsample, concat of the reversed scales, fuse,
    BatchNorm on batch statistics) against JAX ``deterministic=False`` with
    every dropout at 0: logits, and the running statistics updated as flax
    does (biased batch variance, momentum 0.9)."""
    import dataclasses

    from vivim_tpu_torch.nn.layers import use_generator

    def no_drop(c):
        return dataclasses.replace(
            c, drop_path_rate=0.0, dropout_rate=0.0,
            segformer=dataclasses.replace(c.segformer, drop_path_rate=0.0,
                                          classifier_dropout=0.0))

    model = Vivim(no_drop(VivimConfig.micro_test()))
    model.load_state_dict(_port_model("micro", False)[0].state_dict())
    jcfg = no_drop(JConfig.micro_test())
    variables = vivim_params_from_torch(_numpy_sd(model), jcfg)
    clip = np.random.default_rng(2).standard_normal(
        (2, 2, 32, 32, 3)).astype(np.float32)
    want, upd = JVivim(jcfg).apply(variables, jnp.asarray(clip),
                                   deterministic=False,
                                   rngs={"dropout": jax.random.PRNGKey(0)},
                                   mutable=["batch_stats"])
    use_generator(model.train(), torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = model(torch.from_numpy(clip))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-3)
    bn = model.decoder.batch_norm
    jbn = upd["batch_stats"]["batch_norm"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(jbn["mean"]), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(jbn["var"]), rtol=1e-3, atol=1e-4)
    assert int(bn.num_batches_tracked) == 1
