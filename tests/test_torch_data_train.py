"""The port's training data pipeline against the JAX package's, on the same
files and seeds: augmentations, training and eval clips, and the loader's
order and batches.  Everything is exactly equal (``array_equal``): both
packages draw from the same ``random.Random`` streams through the same PIL
calls and the same native ops."""

import argparse
import random

import numpy as np
import pytest
from PIL import Image

from tests.data_fixtures import make_gathered_tree
from tests.test_torch_native import jax_native_lib
from vivim_tpu.cli import infer as jinfer
from vivim_tpu.data import augment as jaug
from vivim_tpu.data import clips as jclips
from vivim_tpu.data.dataset import ClipDataset as JClipDataset
from vivim_tpu.data.loader import DataLoader as JDataLoader
from vivim_tpu_torch import native
from vivim_tpu_torch.cli import infer
from vivim_tpu_torch.data import augment as aug
from vivim_tpu_torch.data import clips
from vivim_tpu_torch.data.dataset import ClipDataset
from vivim_tpu_torch.data.loader import DataLoader

@pytest.fixture(scope="module", autouse=True)
def native_libs():
    """Both packages' native libraries, built before any clip is loaded
    (the JAX one race-free, see ``jax_native_lib``)."""
    return native.get_lib(), jax_native_lib()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Two videos of 18 frames at 40 px (a resize to 32 px happens)."""
    root = tmp_path_factory.mktemp("tree") / "train"
    return make_gathered_tree(str(root), n_videos=2, n_frames=18, size=40)


def _assert_items_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if k == "paths":
            assert list(got[k]) == list(want[k])
        else:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _frame_and_masks(seed):
    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 256, (48, 40, 3), np.uint8))
    yy, xx = np.mgrid[:48, :40]
    masks = []
    for c in range(3):
        cy, cx = rng.integers(8, 32, 2)
        blob = ((yy - cy) ** 2 + (xx - cx) ** 2 < 60 + 20 * c) * 255
        masks.append(Image.fromarray(blob.astype(np.uint8)))
    return img, masks


@pytest.mark.parametrize("intensity,pepper", [
    ("none", False), ("light", False), ("medium", False), ("heavy", False),
    ("medium", True)])
def test_apply_augmentation_equals_jax(intensity, pepper):
    for seed in range(20):
        img, masks = _frame_and_masks(seed)
        got = aug.apply_augmentation(img, masks, intensity,
                                     random.Random(seed), enable_pepper=pepper)
        want = jaug.apply_augmentation(img, masks, intensity,
                                       random.Random(seed),
                                       enable_pepper=pepper)
        np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
        assert len(got[1]) == len(want[1]) == 3
        for g, w in zip(got[1], want[1]):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_select_random_equals_jax():
    windows = [[i] for i in range(10)]
    for epoch in range(4):
        got = clips.select_random(windows, 4, seed=42, epoch=epoch)
        assert got == jclips.select_random(windows, 4, seed=42, epoch=epoch)
        assert [0] not in got and got == sorted(got)
    assert clips.select_random(windows, None, 1, 0) == windows


DATASET_CASES = {
    "eval": dict(augment="none", with_edges=False),
    "none_edges": dict(augment="none"),
    "medium": dict(augment="medium"),
    "heavy": dict(augment="heavy", with_edges=False),
    "pre_resize": dict(augment="medium", pre_resize=True),
    "cache_decoded": dict(augment="medium", cache_decoded=True),
    "dynamic": dict(augment="light", dynamic=True, max_num=2),
}


@pytest.mark.parametrize("case", sorted(DATASET_CASES))
def test_load_clip_equals_jax(tree, case):
    kw = dict(size=32, clip_len=3, seed=7, **DATASET_CASES[case])
    ds, jds = ClipDataset(tree, **kw), JClipDataset(tree, **kw)
    for epoch in range(3 if kw.get("dynamic") else 1):
        ds.set_epoch(epoch)
        jds.set_epoch(epoch)
        assert len(ds) == len(jds) > 0
        assert [s.frame_paths for s in ds.samples] == \
            [s.frame_paths for s in jds.samples]
        for i in range(len(ds)):
            for rng_seed in (None, 100 + i):  # the default rng, and a given one
                rng = lambda: (None if rng_seed is None
                               else random.Random(rng_seed))
                got, want = ds.load_clip(i, rng()), jds.load_clip(i, rng())
                _assert_items_equal(got, want)
                if kw.get("cache_decoded"):  # a second load hits the cache
                    _assert_items_equal(ds.load_clip(i, rng()), want)
    if kw.get("cache_decoded"):
        assert ds._cache_bytes == jds._cache_bytes > 0


def test_infer_cli_clips_equal_jax(tree):
    """The infer CLIs' datasets and loaders give the model the same clips
    on the same PNGs (the port resized with PIL before, the JAX package
    with its native ops)."""
    args = argparse.Namespace(data_dir=tree, image_size=32, clip_length=3,
                              batch_size=2, gathered=True)
    ds, dl = infer.prepare_test_data(args)
    jds, jdl = jinfer.prepare_test_data(args)
    assert len(ds) == len(jds) > 0
    for i in range(len(ds)):
        _assert_items_equal(ds.load_clip(i), jds.load_clip(i))
    batches, jbatches = list(dl), list(jdl)
    assert len(batches) == len(jbatches) == len(dl)
    for got, want in zip(batches, jbatches):
        _assert_items_equal(got, want)


@pytest.mark.parametrize("process_count", [1, 2])
def test_loader_batches_equal_jax(tree, process_count):
    """Shuffled batches over two epochs (set_epoch re-draws the dynamic
    clips and the order), and each process's block of them."""
    kw = dict(size=32, clip_len=3, seed=3, augment="medium", dynamic=True,
              max_num=3)
    for pi in range(process_count):
        lkw = dict(batch_size=2, shuffle=True, seed=5, process_index=pi,
                   process_count=process_count)
        dl = DataLoader(ClipDataset(tree, **kw), num_workers=2, **lkw)
        jdl = JDataLoader(JClipDataset(tree, **kw), num_workers=0, **lkw)
        orders = []
        for epoch in range(2):
            dl.set_epoch(epoch)
            jdl.set_epoch(epoch)
            assert dl._order() == jdl._order()
            orders.append(dl._order())
            batches, jbatches = list(dl), list(jdl)
            assert len(batches) == len(jbatches) == len(dl) > 0
            for got, want in zip(batches, jbatches):
                assert got["clip"].shape[0] == 2 // process_count
                _assert_items_equal(got, want)
        assert orders[0] != orders[1]


def test_loader_validates_process_sharding(tree):
    ds = ClipDataset(tree, size=16, clip_len=3, augment="none")
    with pytest.raises(ValueError):  # 4 % 3 != 0
        DataLoader(ds, batch_size=4, process_count=3)
    with pytest.raises(ValueError):  # index out of range
        DataLoader(ds, batch_size=4, process_index=2, process_count=2)
    with pytest.raises(ValueError):  # partial batches cannot split evenly
        DataLoader(ds, batch_size=4, process_count=2, drop_last=False)
