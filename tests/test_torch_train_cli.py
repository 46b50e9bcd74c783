"""The port's training CLIs against the JAX package's: the same flags and
defaults, the same model at the training defaults (tanh GELU), ``main`` of
train_folds / train_final end to end on the CPU with the JAX run layout,
with ``-pretrain``, ``-hf_dir``, ``-with_edge`` and ``-remat``, the refusal
of every flag whose path is not ported (in the binary CLIs too), and
``DWConv3d`` in bf16 against the JAX module (its taps summed in fp32)."""

import argparse
import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.data_fixtures import make_raw_tree
from vivim_tpu.cli import args as jargs
from vivim_tpu.cli import common as jcommon
from vivim_tpu.nn.layers import DWConv3d as JDWConv3d
from vivim_tpu.nn.vivim import Vivim as JVivim
from vivim_tpu_torch.cli import args as pargs
from vivim_tpu_torch.cli import train_binary, train_final, train_folds
from vivim_tpu_torch.cli import train_polyp
from vivim_tpu_torch.cli.common import build_model
from vivim_tpu_torch.convert.from_jax import vivim_state_dict_from_jax
from vivim_tpu_torch.train.checkpoints import save_params
from vivim_tpu_torch.data.gather import gather_multiclass_frames
from vivim_tpu_torch.nn.layers import DWConv3d

torch.set_num_threads(1)

# every key the JAX Trainer logs in one epoch with validation
TRAIN_KEYS = ("train/loss", "train/jaccard", "train/grad_norm", "train/lr",
              "train/frames_per_sec")
VAL_KEYS = ("val/loss", "val/jacc", "val/dice", "val/accuracy",
            "val/dice_mean", "val/confusion_matrix")
TINY = ["-device", "cpu", "-segformer", "tiny", "-image_size", "32",
        "-clip_length", "3", "-epochs", "1", "-num_workers", "0"]


def _defaults(parser):
    return {a.dest: a.default for a in parser._actions if a.dest != "help"}


def test_parser_has_every_jax_flag_and_default():
    got = _defaults(pargs.build_train_parser())
    want = _defaults(jargs.build_train_parser())
    assert got.pop("device") == "cuda"
    assert got.pop("dist_backend") == "nccl"
    assert got == want
    parsed = pargs.build_train_parser().parse_args(
        ["-exact_gelu", "true", "--train_bs", "3", "-bf16", "1"])
    assert parsed.exact_gelu is True and parsed.train_bs == 3 and parsed.bf16


def _gelu_forms(model):
    return {m.approximate for m in model.modules()
            if hasattr(m, "approximate")}


@pytest.mark.parametrize("argv,approximate", [
    ([], True), (["-exact_gelu", "true"], False)])
def test_build_model_gelu_follows_the_flag(argv, approximate):
    args = pargs.build_train_parser().parse_args(["-segformer", "tiny"] + argv)
    model, cfg = build_model(args, device="cpu")
    assert cfg.segformer.gelu_approximate is approximate
    assert _gelu_forms(model) == {"tanh" if approximate else "none"}


def test_build_model_for_infer_stays_exact():
    args = argparse.Namespace(segformer="tiny", num_classes=3,
                              with_edge=False)
    model, cfg = build_model(args, device="cpu")
    assert cfg.segformer.gelu_approximate is False
    assert _gelu_forms(model) == {"none"}


def _seeded_variables(jmodel, clip, seed=0):
    """Random variables of ``jmodel``'s structure (``eval_shape`` of its
    init: traced, not compiled), from numpy: 0.1-scale normals, norm scales
    near 1, BatchNorm variances in [0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), clip)

    def leaf(path, s):
        name = path[-1].key
        if name == "var":
            return (0.5 + rng.random(s.shape)).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def test_training_default_logits_match_jax_build_model():
    """JAX's build_model at the training defaults (tanh GELU), seeded
    variables of its structure converted by convert/from_jax.py into the
    port's build_model: logits within rtol 1e-3 / atol 1e-4."""
    args = pargs.build_train_parser().parse_args(["-segformer", "tiny"])
    jmodel, jcfg = jcommon.build_model(args)
    assert jcfg.segformer.gelu_approximate
    jmodel = JVivim(dataclasses.replace(jcfg, scan_implementation="ref"))
    clip = np.random.default_rng(0).standard_normal(
        (1, 3, 32, 32, 3)).astype(np.float32)
    variables = _seeded_variables(jmodel, jnp.asarray(clip))
    want = jax.jit(lambda v, x: jmodel.apply(v, x, deterministic=True))(
        variables, jnp.asarray(clip))
    model, cfg = build_model(args, device="cpu")
    model.load_state_dict(vivim_state_dict_from_jax(variables, cfg),
                          strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(clip))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-4)


@pytest.fixture(scope="module")
def fold_tree(tmp_path_factory):
    """fold_{0,1}/{train,val}/<case>/<n>_annotated/ trees: two training
    cases of 6 frames (4 clips of 3) and one validation case."""
    root = tmp_path_factory.mktemp("folds")
    for fold in range(2):
        make_raw_tree(str(root / f"fold_{fold}" / "train"), n_videos=2,
                      n_frames=6, size=40, seed=fold)
        make_raw_tree(str(root / f"fold_{fold}" / "val"), n_videos=1,
                      n_frames=6, size=40, seed=10 + fold)
    return root


@pytest.fixture(scope="module")
def gathered_tree(tmp_path_factory, fold_tree):
    """Fold 0's training cases as the gathered tree train_final reads."""
    out = tmp_path_factory.mktemp("gathered")
    gather_multiclass_frames(str(fold_tree / "fold_0" / "train"), str(out),
                             copy=True)
    return out


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _logged_keys(records):
    return {k for r in records for k in r}


def test_train_folds_main_on_cpu(tmp_path, fold_tree):
    save = tmp_path / "runs"
    results = train_folds.main(
        ["-data_path", str(fold_tree), "-num_folds", "2", "-val_freq", "1",
         "-save_path", str(save), "-exp_name", "cv"] + TINY)
    assert set(results) == {0, 1}
    for fold in range(2):
        run = save / "cv" / f"fold_{fold}"
        assert 0.0 <= results[fold] <= 1.0
        records = _records(run / "metrics.jsonl")
        assert records[0]["config"]["data_path"] == str(fold_tree)
        assert set(TRAIN_KEYS + VAL_KEYS) <= _logged_keys(records)
        assert all(np.isfinite(r["train/loss"]) for r in records
                   if "train/loss" in r)
        ckpts = sorted(os.listdir(run / "ckpt"))
        assert ckpts == ["best_4.pt", "last_4.pt", "manager.json"], ckpts


@pytest.mark.parametrize("wandb", ["false", "true"])
def test_train_final_main_on_cpu(tmp_path, gathered_tree, capsys, wandb):
    save = tmp_path / "runs"
    best = train_final.main(
        ["-data_path", str(gathered_tree), "-wandb", wandb,
         "-save_path", str(save), "-exp_name", "fin", "-bf16", "true",
         "-augment_intensity", "heavy", "-dynamic", "true",
         "-max_numerosity", "1"] + TINY)
    assert np.isfinite(best)
    run = save / "fin" / "final"
    records = _records(run / "metrics.jsonl")
    assert set(TRAIN_KEYS + VAL_KEYS) <= _logged_keys(records)
    assert sorted(os.listdir(run / "ckpt")) == [
        "best_2.pt", "last_2.pt", "manager.json"]
    meta = json.load(open(run / "ckpt" / "manager.json"))
    assert meta["monitor"] == "train/loss" and meta["mode"] == "min"
    if wandb == "true" and importlib.util.find_spec("wandb") is None:
        assert "wandb unavailable" in capsys.readouterr().out


@pytest.fixture(scope="module")
def weight_files(tmp_path_factory):
    """A binary checkpoint with the edge head (``save_params``) and a
    SegFormer snapshot in HF's key layout (``pytorch_model.bin``, with its
    per-stage LayerNorms and classifier), both of the tiny config."""
    root = tmp_path_factory.mktemp("weights")
    args = pargs.build_train_parser().parse_args(
        ["-segformer", "tiny", "-with_edge", "true"])
    binary, _ = build_model(args, device="cpu", seed=5, out_chans=1)
    save_params(str(root / "binary.pt"), binary.state_dict())
    hf = {}
    for k, v in binary.state_dict().items():
        if k.startswith("encoder.downsample_layers."):
            hf["segformer.encoder." + k[len("encoder.downsample_layers."):]] = v
        elif k.startswith("decoder."):
            hf["decode_head." + k[len("decoder."):]] = v
    hf["decode_head.classifier.weight"] = torch.zeros(150, 32, 1, 1)
    hf["decode_head.classifier.bias"] = torch.zeros(150)
    os.makedirs(root / "hf")
    torch.save(hf, root / "hf" / "pytorch_model.bin")
    return root


@pytest.mark.parametrize("cli", [train_folds, train_final])
@pytest.mark.parametrize("flag", ["pretrain", "hf_dir", "with_edge"])
def test_weight_and_edge_flags_run(tmp_path, fold_tree, gathered_tree,
                                   weight_files, capsys, cli, flag):
    """Each flag through the multiclass CLIs: ``-pretrain`` takes the
    binary checkpoint's overlap (all but ``out``), ``-hf_dir`` grafts the
    snapshot, ``-with_edge`` trains the edge head with the center-frame
    edge criterion."""
    argv = {"pretrain": ["-pretrain", str(weight_files / "binary.pt")],
            "hf_dir": ["-hf_dir", str(weight_files / "hf")],
            "with_edge": ["-with_edge", "true"]}[flag]
    data = ["-data_path", str(fold_tree), "-num_folds", "1", "-val_freq",
            "1"]
    if cli is train_final:
        data = ["-data_path", str(gathered_tree)]
    cli.main(data + ["-save_path", str(tmp_path), "-exp_name", "w"] + TINY
             + argv)
    out = capsys.readouterr().out
    if flag == "pretrain":
        assert "kept the init of ['out.bias', 'out.weight']" in out
    if flag == "hf_dir":
        assert f"from {weight_files / 'hf'}" in out
    run = tmp_path / "w" / ("final" if cli is train_final else "fold_0")
    records = _records(run / "metrics.jsonl")
    assert set(TRAIN_KEYS + VAL_KEYS) <= _logged_keys(records)
    assert all(np.isfinite(r["train/loss"]) for r in records
               if "train/loss" in r)


@pytest.mark.parametrize("cli", [train_folds, train_final, train_binary,
                                 train_polyp])
@pytest.mark.parametrize("flag,item", [
    (["-seq_shards", "2"], "torchrun --nproc_per_node 2"),
    (["-n_devices", "2"], "torchrun --nproc_per_node 2"),
    (["-zero", "true"], "pass -n_devices N")],
    ids=["flag0-M12", "flag1-M12", "flag2-M12"])
def test_unported_flags_raise_with_their_roadmap_item(tmp_path, cli, flag,
                                                      item, monkeypatch):
    """The parallel flags, once refused as not ported (ROADMAP M12), now
    run under torchrun: outside it, more than one rank raises with the
    torchrun command to use, and ``-zero`` without a data axis raises the
    JAX package's message; nothing is read before."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match=item):
        cli.main(["-data_path", str(tmp_path)] + TINY + flag)


@pytest.mark.parametrize("cli", [train_folds, train_final, train_binary,
                                 train_polyp])
@pytest.mark.parametrize("level", ["pre_scan", "blocks"])
def test_remat_flag_runs(tmp_path, fold_tree, gathered_tree, monkeypatch,
                         cli, level):
    """``-remat`` in every training CLI: one tiny CPU epoch, and the model
    it built carries the JAX CLIs' mapping of the level (``pre_scan``: the
    Mamba pre-scan chain; ``blocks``: every MambaLayer and SegFormer
    layer)."""
    from tests.test_torch_polyp_otu import _polyp_tree

    built = []

    def recording_build_model(*args, **kw):
        built.append(build_model(*args, **kw))
        return built[-1]

    monkeypatch.setattr(cli, "build_model", recording_build_model)
    data = {train_folds: ["-data_path", str(fold_tree), "-num_folds", "1"],
            train_final: ["-data_path", str(gathered_tree)],
            train_binary: ["-data_path", str(gathered_tree)],
            train_polyp: ["-data_path", _polyp_tree(
                str(tmp_path / "polyp"), n_frames=3, size=40)]}[cli]
    cli.main(data + ["-save_path", str(tmp_path / "runs"), "-exp_name", "r",
                     "-val_freq", "1", "-train_bs", "2", "-val_bs", "2",
                     "-remat", level] + TINY)
    (model, cfg), = built
    assert cfg.remat_pre_scan is (level == "pre_scan")
    assert cfg.remat_blocks is (level == "blocks")
    assert cfg.segformer.remat_layers is (level == "blocks")
    assert {m.remat_pre_scan for m in model.modules()
            if hasattr(m, "remat_pre_scan")} == {level == "pre_scan"}
    ckpts = [f for _, _, fs in os.walk(tmp_path / "runs") for f in fs
             if f.startswith("last_")]
    assert len(ckpts) == 1, ckpts


def test_no_full_batch_raises(tmp_path, gathered_tree):
    with pytest.raises(SystemExit, match="train_bs=9"):
        train_final.main(["-data_path", str(gathered_tree),
                          "-train_bs", "9", "-save_path", str(tmp_path)]
                         + TINY)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dwconv3d_matches_jax(dtype):
    """The port's DWConv3d against the JAX module on the same inputs and
    weights in ``dtype`` (bf16 tolerance 3e-2 / 5e-2; fp32 the modules'
    1e-3 / 1e-4); output in the input's dtype.  In bf16 the weight
    gradient is finite and within 5e-2 of its scale of the fp32 one."""
    B, T, H, W, C = 2, 3, 5, 6, 8
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T * H * W, C)).astype(np.float32)
    kernel = (0.3 * rng.standard_normal((3, 3, 3, 1, C))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(C)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = JDWConv3d(C).apply(
        {"params": {"kernel": jnp.asarray(kernel, jdt),
                    "bias": jnp.asarray(bias, jdt)}},
        jnp.asarray(x, jdt), T, H, W)

    def port(dt):
        mod = DWConv3d(C)
        with torch.no_grad():
            mod.dwconv.weight.copy_(torch.from_numpy(
                np.transpose(kernel, (4, 3, 0, 1, 2))))
            mod.dwconv.bias.copy_(torch.from_numpy(bias))
        return mod.to(dt)

    mod = port(tdt)
    xt = torch.from_numpy(x).to(tdt)
    got = mod(xt, T, H, W)
    assert got.dtype == tdt
    rtol, atol = (3e-2, 5e-2) if dtype == "bfloat16" else (1e-3, 1e-4)
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)
    if dtype == "bfloat16":
        cot = torch.from_numpy(rng.standard_normal(x.shape).astype(
            np.float32))
        (got.float() * cot).sum().backward()
        ref = port(torch.float32)
        (ref(torch.from_numpy(x), T, H, W) * cot).sum().backward()
        g, r = mod.dwconv.weight.grad, ref.dwconv.weight.grad
        assert g.dtype == torch.bfloat16 and torch.isfinite(g).all()
        err = (g.float() - r).abs().max().item()
        assert err <= 5e-2 * r.abs().max().item(), err
