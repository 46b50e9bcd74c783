"""The port's raw-tree gathering and fold splitting against the JAX
package's: the same indexes, the same copied trees byte for byte, the same
best seed and CSV rows, and ``make_folds.main`` writing the same tree."""

import os

import pandas as pd
import pytest

from tests.data_fixtures import make_raw_tree
from vivim_tpu.cli import make_folds as jmake_folds
from vivim_tpu.data import folds as jfolds
from vivim_tpu.data import gather as jgather
from vivim_tpu_torch.cli import make_folds
from vivim_tpu_torch.data import folds, gather


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """Six cases of 4 annotated frames, solid masks on every other one."""
    tmp = tmp_path_factory.mktemp("raw")
    root = str(tmp / "raw")
    for v in range(6):
        make_raw_tree(root, n_videos=1, n_frames=4, seed=v)
        os.rename(os.path.join(root, "caseA_vid0"),
                  os.path.join(root, f"case_{v}"))
    return tmp, root


@pytest.mark.parametrize("fn", ["gather_multiclass_frames",
                                "gather_binary_frames"])
def test_gather_index_and_copied_tree_equal_jax(tmp_path, fn):
    raw_root = make_raw_tree(str(tmp_path / "raw"))
    got = getattr(gather, fn)(raw_root, str(tmp_path / "port"), copy=True)
    want = getattr(jgather, fn)(raw_root, str(tmp_path / "jax"), copy=True)
    assert got == want and set(got) == {"caseA_vid0", "caseA_vid1"}
    tree = _tree(tmp_path / "port")
    assert tree == _tree(tmp_path / "jax") and tree
    assert getattr(gather, fn)(raw_root, copy=False) == want


def test_gather_frame_sequences_equal_jax(tmp_path):
    raw_root = make_raw_tree(str(tmp_path / "raw"), n_frames=6)
    n = gather.gather_frame_sequences(raw_root, str(tmp_path / "port"), 3)
    assert n == jgather.gather_frame_sequences(raw_root, str(tmp_path / "jax"),
                                               3) > 0
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


def test_stratified_group_folds_equal_jax(raw):
    tmp, root = raw
    kw = dict(n_splits=2, max_attempts=3, copy=True, plots=False)
    got_index, got_balance, got_seed = folds.make_stratified_group_folds(
        root, str(tmp / "port"), **kw)
    want_index, want_balance, want_seed = jfolds.make_stratified_group_folds(
        root, str(tmp / "jax"), **kw)
    assert got_seed == want_seed
    pd.testing.assert_frame_equal(got_balance, want_balance)
    for csv in ("split_metadata.csv", "fold_statistics.csv"):
        pd.testing.assert_frame_equal(pd.read_csv(tmp / "port" / csv),
                                      pd.read_csv(tmp / "jax" / csv))
    assert len(got_index) == 2
    for g, w in zip(got_index, want_index):
        for split in ("train", "val"):
            assert ([r["frame_path"] for r in g[split]]
                    == [r["frame_path"] for r in w[split]])
    assert _tree(tmp / "port") == _tree(tmp / "jax")
    for df in (folds.gather_annotated_frames(root),
               jfolds.gather_annotated_frames(root)):
        assert len(df) == 24


def test_make_folds_main_writes_the_jax_tree(tmp_path, capsys):
    raw_root = make_raw_tree(str(tmp_path / "raw"), n_videos=6, n_frames=4)
    argv = ["--n_splits", "2", "--max_attempts", "2"]
    make_folds.main([raw_root, str(tmp_path / "port")] + argv)
    out = capsys.readouterr().out
    jmake_folds.main([raw_root, str(tmp_path / "jax")] + argv)
    assert "best seed" in out and out == capsys.readouterr().out
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert set(got) == set(want)
    assert any(p.startswith("fold_1") for p in got)
    for p in got:  # the figures are rendered by matplotlib: names only
        if not p.endswith(".png") or os.sep in p:
            assert got[p] == want[p], p
