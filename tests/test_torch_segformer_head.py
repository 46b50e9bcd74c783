"""The port's SegFormer decode head and semantic-segmentation model
(``nn/segformer.py``: ``SegformerDecodeHead``, ``SegformerForSemantic
Segmentation``) against a seeded HuggingFace model built from a config (no
download) and against the JAX package's modules.

- HF: its state_dict loads strictly (HF's keys), eval logits at the JAX
  test's tolerance (``tests/test_segformer.py``: rtol 1e-4 / atol 2e-4; the
  port keeps the JAX package's LayerNorm eps 1e-6 where HF has 1e-5,
  ROADMAP F2, inside that tolerance at this size);
- JAX: weights and BatchNorm statistics through ``convert/from_jax.py::
  segformer_state_dict_from_jax``, eval logits within 1e-4; the head alone
  with ``fuse_only``; a train-mode forward with dropout and drop-path 0
  against flax's ``mutable=["batch_stats"]``: the logits and the updated
  running mean and variance (flax's biased variance, momentum 0.9).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from vivim_tpu.convert import torch_to_jax as cv
from vivim_tpu.nn import segformer as jsf
from vivim_tpu_torch.convert import from_jax
from vivim_tpu_torch.nn import segformer as tsf

torch.set_num_threads(1)

SMALL = dict(depths=(1, 2, 1, 1), hidden_sizes=(8, 16, 24, 32),
             num_attention_heads=(1, 2, 2, 4), sr_ratios=(8, 4, 2, 1),
             decoder_hidden_size=32, num_labels=5, drop_path_rate=0.1,
             classifier_dropout=0.1)
NO_DROP = dict(SMALL, drop_path_rate=0.0, classifier_dropout=0.0)


def _hf(cfg):
    hf_cfg = transformers.SegformerConfig(
        num_channels=cfg.num_channels, depths=list(cfg.depths),
        hidden_sizes=list(cfg.hidden_sizes),
        num_attention_heads=list(cfg.num_attention_heads),
        sr_ratios=list(cfg.sr_ratios), patch_sizes=list(cfg.patch_sizes),
        strides=list(cfg.strides), mlp_ratios=list(cfg.mlp_ratios),
        decoder_hidden_size=cfg.decoder_hidden_size,
        num_labels=cfg.num_labels, drop_path_rate=cfg.drop_path_rate,
        classifier_dropout_prob=cfg.classifier_dropout)
    torch.manual_seed(0)
    model = transformers.SegformerForSemanticSegmentation(hf_cfg).eval()
    bn = model.decode_head.batch_norm
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():  # statistics off their init, so that they count
        bn.running_mean.copy_(0.1 * torch.randn(bn.num_features, generator=g))
        bn.running_var.copy_(0.5 + torch.rand(bn.num_features, generator=g))
    return model


def _image(seed, size=64, batch=1):
    return np.random.default_rng(seed).standard_normal(
        (batch, size, size, 3)).astype(np.float32)


def _jax_variables(cfg):
    """JAX variables from the seeded HF model's weights (the JAX test's
    route), so that every tensor is off its init."""
    return cv.segformer_params_from_torch(_hf(cfg).state_dict(), cfg)


def test_logits_match_hf_loaded_strictly():
    cfg = tsf.SegformerConfig(**SMALL)
    hf = _hf(cfg)
    model = tsf.SegformerForSemanticSegmentation(cfg).eval()
    model.load_state_dict(hf.state_dict(), strict=True)
    x = _image(1)
    with torch.no_grad():
        want = hf(torch.from_numpy(x).permute(0, 3, 1, 2)).logits
        got = model(torch.from_numpy(x))
    assert got.shape == (1, 16, 16, 5)
    np.testing.assert_allclose(got.numpy(),
                               want.permute(0, 2, 3, 1).numpy(),
                               rtol=1e-4, atol=2e-4)


def _pair(cfg_kw):
    jcfg = jsf.SegformerConfig(**cfg_kw)
    tcfg = tsf.SegformerConfig(**cfg_kw)
    variables = _jax_variables(jcfg)
    model = tsf.SegformerForSemanticSegmentation(tcfg)
    model.load_state_dict(
        from_jax.segformer_state_dict_from_jax(variables, tcfg), strict=True)
    return jcfg, variables, model


def test_logits_match_jax_through_converter():
    jcfg, variables, model = _pair(SMALL)
    x = _image(2, batch=2)
    want = jsf.SegformerForSemanticSegmentation(jcfg).apply(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_fuse_only_head_matches_jax():
    """``fuse_only``: the head stops after the dropout, has no classifier,
    and its fused map is the JAX head's."""
    jcfg, variables, full = _pair(SMALL)
    full.eval()
    x = _image(3)
    feats_j = jsf.SegformerEncoder(jcfg).apply(
        {"params": variables["params"]["encoder"]}, jnp.asarray(x))
    head_vars = {"params": variables["params"]["decode_head"],
                 "batch_stats": variables["batch_stats"]["decode_head"]}
    want = jsf.SegformerDecodeHead(jcfg, fuse_only=True).apply(
        head_vars, feats_j)
    head = tsf.SegformerDecodeHead(full.cfg, fuse_only=True).eval()
    sd = {k[len("decode_head."):]: v
          for k, v in full.state_dict().items()
          if k.startswith("decode_head.") and ".classifier." not in k}
    head.load_state_dict(sd, strict=True)
    assert not hasattr(head, "classifier")
    with torch.no_grad():
        feats = full.segformer.encoder(torch.from_numpy(x))
        got = head(feats)
    for f, fj in zip(feats, feats_j):
        np.testing.assert_allclose(f.numpy(), np.asarray(fj), rtol=1e-4,
                                   atol=1e-4)
    assert got.shape == (1, 16, 16, jcfg.decoder_hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_train_mode_batch_norm_matches_flax():
    """Train mode with dropout and drop-path 0: the logits (BatchNorm on
    the batch statistics) and the running statistics it leaves, against
    flax's ``mutable=["batch_stats"]``."""
    jcfg, variables, model = _pair(NO_DROP)
    x = _image(5, batch=2)
    want, updates = jsf.SegformerForSemanticSegmentation(jcfg).apply(
        variables, jnp.asarray(x), deterministic=False,
        mutable=["batch_stats"])
    got = model.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    stats = updates["batch_stats"]["decode_head"]["batch_norm"]
    bn = model.decode_head.batch_norm
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-5,
                               atol=1e-6)
    assert int(bn.num_batches_tracked) == 1


def test_train_mode_dropout_needs_a_generator():
    """The head's dropout draws only from an explicit generator, and one
    seed gives one mask."""
    from vivim_tpu_torch.nn.layers import use_generator

    cfg = tsf.SegformerConfig(**dict(SMALL, drop_path_rate=0.0,
                                     classifier_dropout=0.5))
    model = tsf.SegformerForSemanticSegmentation(cfg).train()
    x = torch.from_numpy(_image(6))
    with pytest.raises(RuntimeError, match="explicit generator"):
        model(x)
    outs = []
    for _ in range(2):
        use_generator(model, torch.Generator().manual_seed(7))
        outs.append(model(x).detach())
    assert torch.equal(outs[0], outs[1])


def test_b3_keys_are_hf_keys():
    """MiT-b3 with the ADE head width: the port's state_dict keys and
    shapes are HF's (``nvidia/segformer-b3-finetuned-ade-512-512``'s
    architecture, built from a config, no weights fetched)."""
    cfg = dataclasses.replace(tsf.mit_b3(), num_labels=150)
    hf_cfg = transformers.SegformerConfig(
        depths=list(cfg.depths), hidden_sizes=list(cfg.hidden_sizes),
        decoder_hidden_size=cfg.decoder_hidden_size, num_labels=150)
    with torch.device("meta"):
        hf = transformers.SegformerForSemanticSegmentation(hf_cfg)
        model = tsf.SegformerForSemanticSegmentation(cfg)
    want = {k: tuple(v.shape) for k, v in hf.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
