"""The pretrained-weight flags and the binary CLIs of the port.

- ``-pretrain``: at one config, the port's load equals the JAX package's
  ``maybe_load_pretrained`` on the same weights; a binary checkpoint with
  the edge head into a 3-class model takes exactly the tensors of equal key
  and shape (the semantics the JAX docstring states and the JAX load does
  not reach: fault F4, recorded here by the JAX call's ValueError).
- ``-hf_dir``: a tiny random ``transformers`` SegFormer snapshot grafts as
  the JAX package's ``maybe_load_hf_segformer`` does, and a snapshot of
  another key set raises.
- ``train_binary`` (gathered tree, with the edge loss, and ``-otu true``)
  and ``train_polyp`` run an epoch on the CPU and write the JAX layout.
"""

import argparse
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.data_fixtures import make_gathered_tree
from tests.test_torch_polyp_otu import _polyp_tree
from tests.test_torch_train_cli import _seeded_variables
from vivim_tpu.cli import common as jcommon
from vivim_tpu.convert.torch_to_jax import vivim_params_from_torch
from vivim_tpu.nn.vivim import Vivim as JVivim
from vivim_tpu.nn.vivim import VivimConfig as JConfig
from vivim_tpu.train import checkpoints as jckpt
from vivim_tpu.train import loop as jloop
from vivim_tpu_torch.cli import common, train_binary, train_polyp
from vivim_tpu_torch.convert import from_jax
from vivim_tpu_torch.nn.layers import init_weights
from vivim_tpu_torch.nn.vivim import Vivim, VivimConfig
from vivim_tpu_torch.train import checkpoints
from vivim_tpu_torch.train.loop import create_train_state

torch.set_num_threads(1)

TINY = ["-device", "cpu", "-segformer", "tiny", "-image_size", "32",
        "-clip_length", "3", "-epochs", "1", "-num_workers", "0",
        "-val_freq", "1", "-train_bs", "2", "-val_bs", "2"]
BINARY_VAL_KEYS = ("val/loss", "val/dice", "val/iou", "val/Smeasure",
                   "val/Emeasure", "val/MAE", "val/wFmeasure")


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_side(name, seed, **kw):
    """(JAX config, seeded numpy variables, a JAX TrainState of them)."""
    jcfg = getattr(JConfig, f"{name}_test")(**kw)
    variables = _seeded_variables(JVivim(jcfg), jnp.zeros((1, 3, 32, 32, 3)),
                                  seed)
    state = jloop.TrainState(
        step=0, params=jax.tree_util.tree_map(jnp.asarray,
                                              variables["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        opt_state=None, rng=None)
    return jcfg, variables, state


def _port_model(name, variables=None, seed=0, **kw):
    cfg = getattr(VivimConfig, f"{name}_test")(scan_implementation=None, **kw)
    model = init_weights(Vivim(cfg), torch.Generator().manual_seed(seed))
    if variables is not None:
        model.load_state_dict(from_jax.vivim_state_dict_from_jax(
            variables, cfg))
    return model, cfg


def _port_as_jax(model, jcfg):
    return vivim_params_from_torch(
        {k: v.numpy() for k, v in model.state_dict().items()}, jcfg)


def test_pretrain_same_config_equals_jax(tmp_path, capsys):
    """JAX saves the checkpoint's params with orbax, the port its
    ``vivim_state_dict_from_jax`` through ``save_params``; both load into a
    model initialised from the same other weights.  The parameters agree
    exactly; the BatchNorm statistics are the checkpoint's in the port (the
    reference's init_weight loads the whole state_dict) and stay the
    target's in JAX, which restores params only."""
    jcfg, target, jstate = _jax_side("micro", 1)
    _, ckpt, _ = _jax_side("micro", 0)
    jckpt.save_params(str(tmp_path / "jax"), ckpt["params"])
    want = jcommon.maybe_load_pretrained(
        argparse.Namespace(pretrain=str(tmp_path / "jax")), None, jstate)

    model, cfg = _port_model("micro", target)
    sd = from_jax.vivim_state_dict_from_jax(ckpt, cfg)
    checkpoints.save_params(str(tmp_path / "port.pt"), sd)
    took = common.maybe_load_pretrained(
        argparse.Namespace(pretrain=str(tmp_path / "port.pt")), model)
    assert took == sorted(model.state_dict())
    assert f"took {len(took)} of the model's {len(took)} tensors" in \
        capsys.readouterr().out
    got = _port_as_jax(model, jcfg)
    want_flat, got_flat = _flat(want.params), _flat(got["params"])
    assert set(want_flat) == set(got_flat)
    for k, w in want_flat.items():
        np.testing.assert_array_equal(got_flat[k], w, err_msg=k)
    for k, w in _flat(ckpt["batch_stats"]).items():
        np.testing.assert_array_equal(_flat(got["batch_stats"])[k], w)
    for k, w in _flat(target["batch_stats"]).items():
        np.testing.assert_array_equal(_flat(want.batch_stats)[k], w)


@pytest.mark.parametrize("target_edge", [True, False])
def test_pretrain_binary_edge_into_three_classes(tmp_path, capsys,
                                                 target_edge):
    source, _ = _port_model("tiny", seed=0, out_chans=1, with_edge=True)
    checkpoints.save_params(str(tmp_path / "bin.pt"), source.state_dict())
    ckpt = source.state_dict()
    model, _ = _port_model("tiny", seed=1, out_chans=3, with_edge=target_edge)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    took = common.maybe_load_pretrained(
        argparse.Namespace(pretrain=str(tmp_path / "bin.pt")), model)
    overlap = sorted(k for k in ckpt if k in before
                     and ckpt[k].shape == before[k].shape)
    assert took == overlap
    assert not {"out.weight", "out.bias"} & set(took)
    assert ("edgeocr_cls_head.weight" in took) is target_edge
    after = model.state_dict()
    for k in took:
        assert torch.equal(after[k], ckpt[k]), k
    for k in set(before) - set(took):
        assert torch.equal(after[k], before[k]), k
    out = capsys.readouterr().out
    skipped = ["out.bias", "out.weight"]
    if not target_edge:
        skipped = ["edgeocr_cls_head.bias", "edgeocr_cls_head.weight"] + skipped
    assert f"skipped {skipped}" in out
    assert "kept the init of ['out.bias', 'out.weight']" in out


@pytest.mark.parametrize("target_edge", [True, False])
def test_jax_pretrain_refuses_binary_into_three_classes(tmp_path,
                                                        target_edge):
    """F4: the JAX ``-pretrain`` restores the whole target tree strictly,
    so a binary checkpoint with the edge head does not load into a 3-class
    model (a leaf of another shape, or a key the target lacks)."""
    _, binary, _ = _jax_side("micro", 0, out_chans=1, with_edge=True)
    jckpt.save_params(str(tmp_path / "bin"), binary["params"])
    _, _, state = _jax_side("micro", 1, out_chans=3, with_edge=target_edge)
    with pytest.raises(ValueError, match="shape" if target_edge
                       else "tree structures do not match"):
        jcommon.maybe_load_pretrained(
            argparse.Namespace(pretrain=str(tmp_path / "bin")), None, state)


def test_pretrain_reads_a_checkpoint_manager_file(tmp_path):
    model, _ = _port_model("micro", seed=2)
    manager = checkpoints.CheckpointManager(str(tmp_path))
    manager.save(create_train_state(model, 1e-3, 0.0, 1, seed=0), 3,
                 {"val/dice": 0.5})
    for path in (manager.best_path(), manager.last_path()):
        sd = checkpoints.load_params(path)
        assert sd.keys() == model.state_dict().keys()
        for k, v in model.state_dict().items():
            assert torch.equal(sd[k], v)


def test_pretrain_with_nothing_in_common_raises(tmp_path):
    checkpoints.save_params(str(tmp_path / "x.pt"),
                            {"out.weight": torch.zeros(7, 5, 1, 1)})
    model, _ = _port_model("micro")
    with pytest.raises(SystemExit, match="no tensor of it"):
        common.maybe_load_pretrained(
            argparse.Namespace(pretrain=str(tmp_path / "x.pt")), model)


def _hf_state_dict(seg, seed=0):
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.SegformerConfig(
        num_channels=seg.num_channels, depths=list(seg.depths),
        hidden_sizes=list(seg.hidden_sizes),
        num_attention_heads=list(seg.num_attention_heads),
        sr_ratios=list(seg.sr_ratios), patch_sizes=list(seg.patch_sizes),
        strides=list(seg.strides), mlp_ratios=list(seg.mlp_ratios),
        decoder_hidden_size=seg.decoder_hidden_size, num_labels=3)
    torch.manual_seed(seed)
    hf = transformers.SegformerForSemanticSegmentation(hf_cfg)
    with torch.no_grad():  # BatchNorm statistics other than 0 / 1
        bn = hf.decode_head.batch_norm
        bn.running_mean.normal_(0.0, 0.1)
        bn.running_var.uniform_(0.5, 1.5)
    return {k: v.clone() for k, v in hf.state_dict().items()}


def test_hf_graft_equals_jax(tmp_path):
    jcfg, target, jstate = _jax_side("tiny", 1)
    sd = _hf_state_dict(jcfg.segformer)
    torch.save(sd, tmp_path / "pytorch_model.bin")
    args = argparse.Namespace(hf_dir=str(tmp_path))
    want = jcommon.maybe_load_hf_segformer(args, jcfg, jstate)
    model, _ = _port_model("tiny", target)
    common.maybe_load_hf_segformer(args, model)
    got = _port_as_jax(model, jcfg)
    for what in ("params", "batch_stats"):
        want_flat, got_flat = _flat(getattr(want, what)), _flat(got[what])
        assert set(want_flat) == set(got_flat)
        for k, w in want_flat.items():
            np.testing.assert_array_equal(got_flat[k], w, err_msg=k)
    # and the graft moved the encoder away from the target's weights
    moved = _flat(target["params"])["['encoder']['stage_0']['embed']"
                                    "['proj']['kernel']"]
    assert not np.array_equal(
        _flat(got["params"])["['encoder']['stage_0']['embed']['proj']"
                             "['kernel']"], moved)


@pytest.mark.parametrize("change", ["extra_key", "missing_key",
                                    "another_model"])
def test_hf_graft_refuses_another_key_set(change):
    model, cfg = _port_model("tiny")
    sd = _hf_state_dict(cfg.segformer)
    if change == "extra_key":
        sd["segformer.encoder.block.0.0.extra.weight"] = torch.zeros(3)
    elif change == "missing_key":
        del sd["decode_head.linear_fuse.weight"]
    else:
        sd = {"model.embed.weight": torch.zeros(4, 4),
              "decode_head.classifier.weight": torch.zeros(3, 32, 1, 1)}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="not an HF SegFormer snapshot"):
        from_jax.graft_hf_segformer(model, sd)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])


def test_hf_snapshot_prefers_safetensors(tmp_path, monkeypatch):
    safetensors_torch = pytest.importorskip("safetensors.torch")
    a = {"w": torch.zeros(2, 3)}
    b = {"w": torch.ones(2, 3)}
    with pytest.raises(FileNotFoundError, match="neither"):
        from_jax.load_torch_state_dict(str(tmp_path))
    torch.save(a, tmp_path / "pytorch_model.bin")
    assert torch.equal(from_jax.load_torch_state_dict(str(tmp_path))["w"],
                       a["w"])
    safetensors_torch.save_file(b, str(tmp_path / "model.safetensors"))
    assert torch.equal(from_jax.load_torch_state_dict(str(tmp_path))["w"],
                       b["w"])
    # without the package: a clear error, no fall back to the .bin
    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "safetensors.torch", None)
    with pytest.raises(ImportError, match="safetensors package"):
        from_jax.load_torch_state_dict(str(tmp_path))


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _check_run(run_dir, steps):
    records = _records(os.path.join(run_dir, "metrics.jsonl"))
    logged = {k for r in records for k in r}
    assert {"train/loss", "train/lr"} | set(BINARY_VAL_KEYS) <= logged
    assert all(np.isfinite(r[k]) for r in records for k in r
               if k.startswith(("train/", "val/")))
    assert sorted(os.listdir(os.path.join(run_dir, "ckpt"))) == [
        f"best_{steps}.pt", f"last_{steps}.pt", "manager.json"]
    meta = json.load(open(os.path.join(run_dir, "ckpt", "manager.json")))
    assert meta["monitor"] == "val/dice" and meta["mode"] == "max"
    return records


@pytest.fixture(scope="module")
def gathered(tmp_path_factory):
    """Two videos of 6 frames: 4 clips of 3, 2 steps of batch 2."""
    return make_gathered_tree(str(tmp_path_factory.mktemp("gathered")),
                              n_videos=2, n_frames=6, size=40)


@pytest.mark.parametrize("with_edge", ["false", "true"])
def test_train_binary_main_on_gathered_tree(tmp_path, gathered, capsys,
                                            with_edge):
    metrics = train_binary.main(
        ["-data_path", gathered, "-with_edge", with_edge,
         "-save_path", str(tmp_path), "-exp_name", "b"] + TINY)
    assert set(BINARY_VAL_KEYS) <= set(metrics)
    _check_run(str(tmp_path / "b" / "binary"), 2)
    out = capsys.readouterr().out
    assert "epoch 0: train/loss=" in out and "val/dice=" in out
    assert ("InverseForm term is disabled" in out) is (with_edge == "true")


def test_train_binary_ignores_bf16(tmp_path, gathered):
    """The binary step has no compute dtype, as in the JAX package:
    ``-bf16 true`` trains the same fp32 run."""
    runs = [train_binary.main(
        ["-data_path", gathered, "-bf16", bf16, "-save_path",
         str(tmp_path / bf16)] + TINY) for bf16 in ("false", "true")]
    assert runs[0] == runs[1]


def test_train_binary_main_on_otu(tmp_path):
    root = tmp_path / "otu"
    (root / "images").mkdir(parents=True)
    (root / "annotations").mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        Image.fromarray(rng.integers(0, 255, (40, 48, 3), np.uint8)).save(
            root / "images" / f"c{i}.jpg")
        m = np.zeros((40, 48), np.uint8)
        m[10:30, 12:30] = 255
        Image.fromarray(m).save(root / "annotations" / f"c{i}.PNG")
    metrics = train_binary.main(
        ["-data_path", str(root), "-otu", "true", "-save_path",
         str(tmp_path / "runs"), "-exp_name", "o"] + TINY)
    assert set(BINARY_VAL_KEYS) <= set(metrics)
    _check_run(str(tmp_path / "runs" / "o" / "binary"), 2)


@pytest.mark.parametrize("with_edge", ["false", "true"])
def test_train_polyp_main_on_cpu(tmp_path, with_edge):
    root = _polyp_tree(str(tmp_path / "data"), n_frames=2, size=40)
    metrics = train_polyp.main(
        ["-data_path", root, "-with_edge", with_edge, "-save_path",
         str(tmp_path / "runs"), "-exp_name", "p"] + TINY)
    assert set(BINARY_VAL_KEYS) <= set(metrics)
    _check_run(str(tmp_path / "runs" / "p" / "polyp"), 2)


def test_train_polyp_on_a_test_tree(tmp_path):
    root = _polyp_tree(str(tmp_path / "data"), n_frames=2, size=40)
    test = _polyp_tree(str(tmp_path / "test"), split=None, names=("t",),
                       n_frames=3, size=40)
    metrics = train_polyp.main(
        ["-data_path", root, "-val_path", os.path.join(test, "t"),
         "-save_path", str(tmp_path / "runs")] + TINY)
    assert np.isfinite(metrics["val/Smeasure"])
    with pytest.raises(SystemExit, match="no validation clips"):
        train_polyp.main(["-data_path", root, "-val_path", str(tmp_path),
                          "-save_path", str(tmp_path / "runs")] + TINY)
