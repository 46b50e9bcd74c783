"""The training CLIs with ``-n_devices``, ``-zero`` and ``-seq_shards``, on
gloo process groups of the CPU (``-dist_backend gloo -device cpu``).

``train_folds`` in 2 ranks with ``-n_devices 2 -zero true`` (ZeRO's
threshold lowered for the tiny model's leaves to shard) writes, from rank 0
alone, a checkpoint of whole tensors that ``cli.infer`` reads in one
process; ``-seq_shards 2``, alone and with ``-n_devices 2``, trains the
same fold with the Mamba layers of every stage whose tokens divide over
the ranks sharded (the others whole, with the scan's FALLBACK line);
``train_binary`` runs with ``-n_devices 2`` and with ``-seq_shards 2``.  The errors of a run that is
set up wrong are the JAX package's where it has them, and name the fix.
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

from tests import torch_parallel_helpers as H
from tests.data_fixtures import make_gathered_tree, make_raw_tree
from vivim_tpu_torch.cli import (
    infer,
    train_binary,
    train_final,
    train_folds,
    train_polyp,
)
from vivim_tpu_torch.cli.common import build_model
from vivim_tpu_torch.data.gather import gather_multiclass_frames

torch.set_num_threads(1)

TINY = ["-device", "cpu", "-segformer", "tiny", "-image_size", "32",
        "-clip_length", "3", "-epochs", "1", "-num_workers", "0",
        "-val_freq", "1", "-dist_backend", "gloo"]


@pytest.fixture(scope="module")
def fold_tree(tmp_path_factory):
    """fold_0/{train,val}: two training cases of 6 frames (4 clips of 3)
    and one validation case."""
    root = tmp_path_factory.mktemp("folds")
    make_raw_tree(str(root / "fold_0" / "train"), n_videos=2, n_frames=6,
                  size=40, seed=0)
    make_raw_tree(str(root / "fold_0" / "val"), n_videos=1, n_frames=6,
                  size=40, seed=10)
    return root


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _fold_run(tmp_path, fold_tree, flags, world=2):
    save = tmp_path / "runs"
    H.run_ranks(H.cli_body, world, tmp_path, "train_folds",
                ["-data_path", str(fold_tree), "-num_folds", "1",
                 "-train_bs", "2", "-save_path", str(save),
                 "-exp_name", "cv"] + TINY + flags, H.MIN_ELEMS)
    results = [json.load(open(tmp_path / f"cli_rank{r}.json"))
               for r in range(world)]
    assert all(r == results[0] for r in results)  # the pick, in lockstep
    return save / "cv" / "fold_0", results[0]


def _assert_sharded_layers(tmp_path, world):
    """Every rank sharded the Mamba layers of the tiny model's first three
    stages (3 frames of 8x8, 4x4 and 2x2 tokens) over 2 seq ranks and ran
    the last (3 tokens) whole, with the scan's FALLBACK line."""
    for r in range(world):
        lines = json.load(open(tmp_path / f"cli_log_rank{r}.json"))
        sharded = [x for x in lines if x.startswith("seq-sharded Mamba")]
        assert sorted({x.split(":")[0] for x in sharded}) == [
            f"seq-sharded Mamba stage {i}" for i in range(3)]
        for x in sharded:
            L = (192, 48, 12)[int(x.split(":")[0].split()[-1])]
            assert f"L={L} over 2 'seq' ranks, {L // 2} tokens each" in x
        fallback = [x for x in lines if "FALLBACK" in x]
        assert fallback and all(x.startswith("seq-shard FALLBACK: L=3 % 2")
                                for x in fallback)


def _check_run(run, fold_tree, tmp_path):
    """One writer: the metrics of one rank, the checkpoint of whole
    tensors in the one-card layout; ``cli.infer`` reads it in one
    process."""
    records = _records(run / "metrics.jsonl")
    assert sum("config" in r for r in records) == 1
    assert sum("val/dice" in r for r in records) == 1
    assert all(np.isfinite(r["train/loss"]) for r in records
               if "train/loss" in r)
    assert sorted(os.listdir(run / "ckpt")) == ["best_2.pt", "last_2.pt",
                                                "manager.json"]
    saved = torch.load(run / "ckpt" / "last_2.pt", weights_only=True)
    model, _ = build_model(argparse.Namespace(
        segformer="tiny", num_classes=3, with_edge=False), device="cpu")
    want = model.state_dict()
    assert {k: tuple(v.shape) for k, v in saved["model"].items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert [tuple(m.shape) for m in saved["opt"]["mu"]] == [
        tuple(p.shape) for p in model.parameters()]
    data = tmp_path / "test_tree"
    make_gathered_tree(str(data), n_videos=1, n_frames=6, size=32)
    out = tmp_path / "infer"
    summary = infer.main(["--ckpt", str(run / "ckpt"), "--data_dir",
                          str(data), "--image_size", "32", "--clip_length",
                          "3", "--segformer", "tiny", "--output_dir",
                          str(out), "--device", "cpu"])
    on_disk = json.load(open(out / "metrics.json"))
    assert on_disk["confusion_matrix"] == summary["confusion_matrix"]
    assert np.array(on_disk["confusion_matrix"]).sum() == 6 * 32 * 32


def test_train_folds_zero_writes_a_checkpoint_infer_reads(tmp_path,
                                                          fold_tree):
    run, result = _fold_run(tmp_path, fold_tree,
                            ["-n_devices", "2", "-zero", "true"])
    assert 0.0 <= result["0"] <= 1.0
    _check_run(run, fold_tree, tmp_path)


def test_train_folds_seq_shards(tmp_path, fold_tree):
    run, result = _fold_run(tmp_path, fold_tree, ["-seq_shards", "2"])
    assert 0.0 <= result["0"] <= 1.0
    _check_run(run, fold_tree, tmp_path)
    _assert_sharded_layers(tmp_path, 2)


def test_train_folds_hybrid_seq_shards(tmp_path, fold_tree):
    """``-n_devices 2 -seq_shards 2``: 4 ranks, each data rank's clip with
    its Mamba layers sharded over its seq row."""
    run, result = _fold_run(tmp_path, fold_tree,
                            ["-n_devices", "2", "-seq_shards", "2"], world=4)
    assert 0.0 <= result["0"] <= 1.0
    _check_run(run, fold_tree, tmp_path)
    _assert_sharded_layers(tmp_path, 4)


def test_train_binary_data_parallel(tmp_path, fold_tree):
    gathered = tmp_path / "gathered"
    gather_multiclass_frames(str(fold_tree / "fold_0" / "train"),
                             str(gathered), copy=True)
    save = tmp_path / "runs"
    H.run_ranks(H.cli_body, 2, tmp_path, "train_binary",
                ["-data_path", str(gathered), "-train_bs", "2",
                 "-val_bs", "2", "-save_path", str(save), "-exp_name", "b",
                 "-n_devices", "2"] + TINY)
    results = [json.load(open(tmp_path / f"cli_rank{r}.json"))
               for r in range(2)]
    assert results[0] == results[1]
    assert {"val/dice", "val/Smeasure", "val/MAE"} <= set(results[0])
    run = save / "b" / "binary"
    assert sum("config" in r for r in _records(run / "metrics.jsonl")) == 1
    assert sorted(os.listdir(run / "ckpt")) == ["best_2.pt", "last_2.pt",
                                                "manager.json"]


def test_train_binary_seq_shards(tmp_path, fold_tree):
    """``train_binary -seq_shards 2``: the binary step sums the sharded
    layers' gradients over the seq row like the multiclass one."""
    gathered = tmp_path / "gathered"
    gather_multiclass_frames(str(fold_tree / "fold_0" / "train"),
                             str(gathered), copy=True)
    H.run_ranks(H.cli_body, 2, tmp_path, "train_binary",
                ["-data_path", str(gathered), "-train_bs", "2",
                 "-val_bs", "2", "-save_path", str(tmp_path / "runs"),
                 "-exp_name", "b", "-seq_shards", "2"] + TINY)
    results = [json.load(open(tmp_path / f"cli_rank{r}.json"))
               for r in range(2)]
    assert results[0] == results[1]
    assert {"val/dice", "val/Smeasure", "val/MAE"} <= set(results[0])
    _assert_sharded_layers(tmp_path, 2)


@pytest.mark.parametrize("cli", [train_folds, train_final, train_binary,
                                 train_polyp])
@pytest.mark.parametrize("world,flags,match", [
    (None, ["-seq_shards", "2", "-zero", "true"], "pass -n_devices N"),
    ("3", ["-n_devices", "2"],
     r"3 process\(es\) but -n_devices 2 x -seq_shards 1 = 2"),
    ("4", ["-n_devices", "2", "-seq_shards", "2", "-train_bs", "3"],
     "-train_bs 3 must be divisible by the 'data' mesh size 2"),
], ids=["zero_one_data_rank", "world_mismatch", "train_bs"])
def test_parallel_setup_errors(tmp_path, monkeypatch, cli, world, flags,
                               match):
    """Raised before any process group is joined or data read."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    if world is not None:
        monkeypatch.setenv("WORLD_SIZE", world)
    with pytest.raises(SystemExit, match=match):
        cli.main(["-data_path", str(tmp_path)] + TINY + flags)
