"""The program under test, built from a configuration file: the port's
own classes and entry points, with the benchmark's weights loaded.

This is the one module of the benchmark that imports the program
(``vivim_tpu_torch``); the drivers call what it returns.
"""

from __future__ import annotations

import torch


def vivim_config(cfg):
    """The port's ``VivimConfig`` of a Vivim configuration file."""
    from vivim_tpu_torch.nn import segformer as sf
    from vivim_tpu_torch.nn.vivim import VivimConfig

    seg = cfg["segformer"]
    scfg = sf.SegformerConfig(
        num_channels=seg["num_channels"], depths=tuple(seg["depths"]),
        hidden_sizes=tuple(seg["hidden_sizes"]),
        num_attention_heads=tuple(seg["num_attention_heads"]),
        sr_ratios=tuple(seg["sr_ratios"]),
        patch_sizes=tuple(seg["patch_sizes"]), strides=tuple(seg["strides"]),
        mlp_ratios=tuple(seg["mlp_ratios"]),
        hidden_dropout=seg["hidden_dropout_prob"],
        attention_dropout=seg["attention_probs_dropout_prob"],
        drop_path_rate=seg["drop_path_rate"],
        classifier_dropout=seg["classifier_dropout_prob"],
        decoder_hidden_size=seg["decoder_hidden_size"],
        gelu_approximate=cfg["gelu"] != "exact")
    return VivimConfig(
        in_chans=seg["num_channels"], out_chans=cfg["num_classes"],
        depths=tuple(cfg["mamba_depths"]), feat_size=scfg.hidden_sizes,
        drop_path_rate=cfg["drop_path_rate"],
        dropout_rate=cfg["dropout_rate"],
        hidden_size=scfg.decoder_hidden_size, segformer=scfg)


def vivim(cfg, weights, device):
    """The port's Vivim on ``device`` holding ``weights``."""
    from vivim_tpu_torch.nn.vivim import Vivim

    vcfg = vivim_config(cfg)
    if (vcfg.segformer.num_stages != len(cfg["mamba_depths"])
            or cfg["d_state"] != 16 or cfg["d_conv"] != 4
            or cfg["expand"] != 2 or cfg["mlp_ratio"] != 4):
        raise ValueError("the port's MambaLayer has d_state 16, d_conv 4, "
                         "expand 2 and MLP ratio 4: the configuration "
                         "differs")
    with torch.device(device):
        model = Vivim(vcfg)
    model.load_state_dict(weights, strict=True)
    return model


def lm(cfg, weights, device):
    """The port's ``MambaLM`` built as ``load_lm`` builds it from a
    mamba ``config.json``, holding ``weights``; and its parameter dict."""
    from vivim_tpu_torch.nn import lm as lm_lib

    lcfg = lm_lib.config_from_mamba_json(cfg)
    lm_lib.check_kernel_config(lcfg, device)
    with torch.device(device):
        model = lm_lib.MambaLM(lcfg)
    sd = dict(weights)
    sd["lm_head.weight"] = sd["backbone.embedding.weight"]
    model.load_state_dict(sd, strict=True)
    return model.eval(), lm_lib.lm_params(model)
