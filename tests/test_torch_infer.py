"""Inference path of the PyTorch port: ``run_inference`` against the JAX
package's on the same synthetic batches and weights, ``main`` end to end on
a gathered synthetic tree (as tests/test_infer_cli.py does for the JAX
CLI), with matplotlib and wandb absent, the JAX CLI's flags and its clips
of an ungathered tree, and checkpoint loading: a reference ``.ckpt``, a
port trainer's checkpoint file and directory, and a JAX trainer
checkpoint through ``scripts/orbax_to_torch.py``."""

import argparse
import json
import os
import sys

import numpy as np
import pytest
import torch

from tests.data_fixtures import make_gathered_tree
from vivim_tpu.cli import infer as jinfer
from vivim_tpu.convert.torch_to_jax import vivim_params_from_torch
from vivim_tpu.nn.vivim import Vivim as JVivim
from vivim_tpu.nn.vivim import VivimConfig as JConfig
from vivim_tpu_torch.cli import infer
from vivim_tpu_torch.cli.common import build_model

torch.set_num_threads(1)


class _Batches:
    def __init__(self, batches):
        self.batches = batches
        self.batch_size = batches[0]["clip"].shape[0]

    def __iter__(self):
        return iter(self.batches)


def _batches(n, T=3, S=48, C=3, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        labels = rng.integers(0, C, (1, T, S, S))
        out.append({
            "clip": rng.standard_normal((1, T, S, S, 3)).astype(np.float32),
            "masks": np.eye(C, dtype=np.float32)[labels]})
    return out


def _args(tmp_path, **kw):
    base = dict(segformer="tiny", num_classes=3, with_edge=False,
                clip_length=3, image_size=48, output_dir=str(tmp_path),
                save_vis=False, vis_count=0)
    base.update(kw)
    return argparse.Namespace(**base)


def test_run_inference_matches_jax(tmp_path):
    """Same weights and batches: confusion matrices agree on >= 99.9 % of
    pixels (an argmax near a tie may flip), frame counts exactly."""
    args = _args(tmp_path)
    model, _ = build_model(args, device="cpu", seed=1)
    loader = _Batches(_batches(3))
    res, cm, perf = infer.run_inference(args, model, loader, device="cpu")

    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    jcfg = JConfig.tiny_test(scan_implementation=None)
    variables = vivim_params_from_torch(sd, jcfg)
    jres, jcm, jperf = jinfer.run_inference(args, JVivim(jcfg), variables,
                                            loader)
    total = 3 * 3 * 48 * 48
    assert cm.sum() == jcm.sum() == total
    assert perf["total_frames"] == jperf["total_frames"] == 9
    agree = 1.0 - np.abs(cm - jcm).sum() / (2.0 * total)
    assert agree >= 0.999, (cm, jcm)
    assert res["class_counts"] == jres["class_counts"]
    for m in ("dice", "jaccard", "precision", "recall"):
        np.testing.assert_allclose(res[m]["mean"], jres[m]["mean"],
                                   atol=1e-3)


def test_infer_main_end_to_end(tmp_path):
    data_dir = tmp_path / "test_tree"
    make_gathered_tree(str(data_dir), n_videos=2, n_frames=6, size=48)
    model, _ = build_model(_args(tmp_path), device="cpu")
    ckpt = tmp_path / "vivim_tiny.pt"
    torch.save(model.state_dict(), ckpt)
    out_dir = tmp_path / "results"
    summary = infer.main([
        "--ckpt", str(ckpt), "--data_dir", str(data_dir),
        "--image_size", "48", "--clip_length", "3", "--segformer", "tiny",
        "--output_dir", str(out_dir), "--save_vis", "true",
        "--vis_count", "2", "--device", "cpu"])
    on_disk = json.load(open(out_dir / "metrics.json"))
    assert on_disk["confusion_matrix"] == summary["confusion_matrix"]
    assert on_disk["performance"]["total_frames"] == 12  # 2 vids x 2 clips x 3
    assert on_disk["performance"]["device"] == "cpu"
    cm = np.array(on_disk["confusion_matrix"])
    assert cm.shape == (3, 3) and cm.sum() == 12 * 48 * 48
    for m in ("dice", "jaccard", "precision", "recall"):
        assert np.isfinite(on_disk["metrics"][m]["mean"])
    pngs = [f for f in os.listdir(out_dir) if f.endswith(".png")]
    assert sum(f.startswith("confusion") for f in pngs) == 3
    assert any(f.startswith("vis_") for f in pngs)


def test_load_model_reads_reference_ckpt_and_refuses_orbax(tmp_path):
    """A Lightning-style .ckpt (``model.`` prefix, the unused
    ``decoder.classifier``) loads strictly; a directory (orbax) raises."""
    args = _args(tmp_path, ckpt=str(tmp_path / "ref.ckpt"))
    src, _ = build_model(args, device="cpu", seed=7)
    sd = {f"model.{k}": v for k, v in src.state_dict().items()}
    sd["model.decoder.classifier.weight"] = torch.zeros(3, 32, 1, 1)
    torch.save({"state_dict": sd, "epoch": 3}, args.ckpt)
    model, _ = infer.load_model(args, device="cpu")
    for k, v in src.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    args.ckpt = str(tmp_path)
    with pytest.raises(ValueError, match="orbax"):
        infer.load_model(args, device="cpu")


def _manager_run(tmp_path):
    """A trainer's ckpt directory of a tiny model: best_2.pt (the weights
    of seed 3) and last_4.pt (other weights)."""
    from vivim_tpu_torch.train import loop
    from vivim_tpu_torch.train.checkpoints import CheckpointManager

    args = _args(tmp_path)
    model, _ = build_model(args, device="cpu", seed=3)
    best = {k: v.clone() for k, v in model.state_dict().items()}
    state = loop.create_train_state(model, 1e-3, 0.0, 4, seed=0)
    ckpt = CheckpointManager(str(tmp_path / "run" / "ckpt"))
    ckpt.save(state, 2, {"val/dice": 0.5})
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    ckpt.save(state, 4, {"val/dice": 0.1})
    assert sorted(os.listdir(ckpt.directory)) == [
        "best_2.pt", "last_4.pt", "manager.json"]
    return ckpt.directory, best


@pytest.mark.parametrize("as_dir", [False, True])
def test_load_model_reads_trainer_checkpoints(tmp_path, as_dir):
    """A port trainer's checkpoint file, and its directory (best before
    last, as the JAX CLI picks), load through ``load_model``."""
    directory, best = _manager_run(tmp_path)
    args = _args(tmp_path, ckpt=directory if as_dir
                 else os.path.join(directory, "best_2.pt"))
    model, _ = infer.load_model(args, device="cpu")
    for k, v in best.items():
        assert torch.equal(model.state_dict()[k], v), k


def test_checkpoint_pick_rule_is_by_name(tmp_path):
    """The JAX CLI's rule: ``best_*`` before ``last_*``, the last name in
    sorted order, so best_99 sorts after best_100 (ROADMAP F5)."""
    for name in ("best_100.pt", "best_99.pt", "last_100.pt",
                 "manager.json"):
        (tmp_path / name).write_bytes(b"")
    assert infer.checkpoint_file(str(tmp_path)) == str(tmp_path
                                                       / "best_99.pt")
    for name in ("best_100.pt", "best_99.pt"):
        (tmp_path / name).unlink()
    assert infer.checkpoint_file(str(tmp_path)) == str(tmp_path
                                                       / "last_100.pt")


def test_orbax_directory_raises_naming_the_converter(tmp_path):
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(tmp_path / "params"), {"w": np.zeros(3, np.float32)})
    ckptr.wait_until_finished()
    args = _args(tmp_path, ckpt=str(tmp_path / "params"))
    with pytest.raises(ValueError, match="scripts/orbax_to_torch.py"):
        infer.load_model(args, device="cpu")


def test_parser_has_every_jax_flag_and_default():
    def defaults(ns):
        return vars(ns)

    argv = ["--ckpt", "c", "--data_dir", "d"]
    got = defaults(infer.parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == defaults(jinfer.parse_args(argv))
    parsed = infer.parse_args(argv + ["--gathered", "false", "-cv_group",
                                      "g", "--wandb", "1"])
    assert not parsed.gathered and parsed.cv_group == "g" and parsed.wandb


def test_ungathered_tree_gives_the_jax_clips(tmp_path):
    """``--gathered false``: the raw tree indexed in place gives the JAX
    CLI's clips, frames and masks alike."""
    from tests.data_fixtures import make_raw_tree

    make_raw_tree(str(tmp_path / "raw"), n_videos=2, n_frames=6, size=40)
    args = _args(tmp_path, data_dir=str(tmp_path / "raw"), gathered=False,
                 batch_size=1)
    ds, _ = infer.prepare_test_data(args)
    jds, _ = jinfer.prepare_test_data(args)
    assert len(ds) == len(jds) == 4
    for i in range(len(ds)):
        got, want = ds.load_clip(i), jds.load_clip(i)
        assert sorted(got) == sorted(want)
        for k in ("clip", "masks"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _main_argv(tmp_path, ckpt, out_dir):
    data_dir = tmp_path / "test_tree"
    if not data_dir.exists():
        make_gathered_tree(str(data_dir), n_videos=1, n_frames=6, size=48)
    return ["--ckpt", str(ckpt), "--data_dir", str(data_dir),
            "--image_size", "48", "--clip_length", "3", "--segformer",
            "tiny", "--output_dir", str(out_dir), "--device", "cpu"]


def test_main_without_matplotlib_or_wandb_still_writes_metrics(
        tmp_path, monkeypatch, capsys):
    """matplotlib and wandb blocked from importing: ``--wandb true``
    carries on, the heatmaps are named as not written, and metrics.json
    holds the confusion matrix."""
    directory, _ = _manager_run(tmp_path)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "wandb", None)
    out_dir = tmp_path / "results"
    summary = infer.main(_main_argv(tmp_path, directory, out_dir)
                         + ["--wandb", "true"])
    out = capsys.readouterr().out
    assert "[infer] wandb unavailable" in out
    assert ("matplotlib cannot be imported: not writing confusion_matrix.png, "
            "confusion_matrix_row_norm.png, confusion_matrix_col_norm.png"
            in out)
    on_disk = json.load(open(out_dir / "metrics.json"))
    assert on_disk["confusion_matrix"] == summary["confusion_matrix"]
    assert np.array(on_disk["confusion_matrix"]).sum() == 6 * 48 * 48
    assert not [f for f in os.listdir(out_dir) if f.endswith(".png")]


def test_orbax_to_torch_converts_a_jax_trainer_checkpoint(tmp_path):
    """scripts/orbax_to_torch.py on the ckpt directory of the JAX
    CheckpointManager (a tiny Vivim's seeded variables, BatchNorm
    statistics included):
    the .pt it writes gives the JAX logits within 1e-3 through
    ``load_model``."""
    import importlib.util

    import jax
    import jax.numpy as jnp

    from vivim_tpu.cli import common as jcommon
    from vivim_tpu.train import loop as jloop
    from vivim_tpu.train.checkpoints import CheckpointManager as JManager

    args = _args(tmp_path)
    jmodel, _ = jcommon.build_model(args)
    clip = np.random.default_rng(0).standard_normal(
        (1, 3, 48, 48, 3)).astype(np.float32)
    # seeded variables of the model's structure (traced, not compiled)
    rng = np.random.default_rng(1)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.asarray(clip))
    variables = jax.tree_util.tree_map_with_path(
        lambda path, s: jnp.asarray(
            (0.5 if path[-1].key == "var" else 0.0)
            + (rng.random(s.shape) if path[-1].key == "var"
               else 0.1 * rng.standard_normal(s.shape)), jnp.float32),
        shapes)
    params, stats = variables["params"], variables["batch_stats"]
    tx, _ = jloop.make_optimizer(1e-3, 0.0, 2)
    state = jloop.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                             batch_stats=stats, opt_state=tx.init(params),
                             rng=jax.random.PRNGKey(1))
    jckpt = JManager(str(tmp_path / "jax_run" / "ckpt"))
    jckpt.save(state, 2, {"val/dice": 0.5})
    jckpt.wait()
    want = jax.jit(lambda v, x: jmodel.apply(v, x, deterministic=True))(
        {"params": state.params, "batch_stats": stats}, jnp.asarray(clip))

    spec = importlib.util.spec_from_file_location(
        "orbax_to_torch", os.path.join(os.path.dirname(__file__), "..",
                                       "scripts", "orbax_to_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    out = tmp_path / "vivim.pt"
    script.main([jckpt.directory, str(out), "--segformer", "tiny"])
    model, _ = infer.load_model(_args(tmp_path, ckpt=str(out)),
                                device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(clip))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                               rtol=0)
