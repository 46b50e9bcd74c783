"""The port's OTU_2D and polyp datasets against the JAX package's: clips,
masks and edges equal (``assert_array_equal``) at every augmentation
setting, with the same per-clip ``random.Random`` draws; the polyp Kvasir
sort, centered windows at both ends of a video, the test layouts, and the
loader's batches over both."""

import os
import random

import numpy as np
import pytest
import torch
from PIL import Image

from vivim_tpu.data import loader as jloader
from vivim_tpu.data import otu as jotu
from vivim_tpu.data import polyp as jpolyp
from vivim_tpu_torch.data import loader as tloader
from vivim_tpu_torch.data import otu as totu
from vivim_tpu_torch.data import polyp as tpolyp

torch.set_num_threads(1)


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        if k == "paths":
            assert tuple(got[k]) == tuple(want[k])
        else:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def otu_root(tmp_path_factory):
    """images/*.jpg (one upper-case .JPG) with annotations/*.PNG and one
    lower-case .png mask."""
    root = tmp_path_factory.mktemp("otu")
    (root / "images").mkdir()
    (root / "annotations").mkdir()
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:72, :90]
    for i in range(4):
        img = rng.integers(0, 255, (72, 90, 3), np.uint8)
        ext = "JPG" if i == 3 else "jpg"
        Image.fromarray(img).save(root / "images" / f"case_{i}.{ext}")
        cy, cx = rng.integers(20, 50, 2)
        m = (((yy - cy) ** 2 + (xx - cx) ** 2 < 300) * 255).astype(np.uint8)
        Image.fromarray(m).save(
            root / "annotations" / f"case_{i}.{'png' if i == 2 else 'PNG'}")
    return str(root)


@pytest.mark.parametrize("augment", ["none", "light", "medium", "heavy"])
def test_otu_clips_equal_jax(otu_root, augment):
    want = jotu.OTUDataset(otu_root, 40, augment=augment, seed=3)
    got = totu.OTUDataset(otu_root, 40, augment=augment, seed=3)
    assert got.images == want.images and len(got) == 4
    for i in range(len(want)):
        _assert_same(got.load_clip(i), want.load_clip(i))
    # an explicit rng draws the same augmentation on both sides
    _assert_same(got.load_clip(1, random.Random(9)),
                 want.load_clip(1, random.Random(9)))


def test_otu_without_images_raises(tmp_path):
    with pytest.raises(ValueError, match="no images"):
        totu.OTUDataset(str(tmp_path), 32)


def _polyp_tree(root, split="Train", names=("vid0", "vid1"), n_frames=7,
                size=44, ext="jpg", seed=0):
    """{root}/{split}/{video}/{Frame,GT}: frames named by number (out of
    lexical order past 9), GT masks with soft edges (continuous after the
    bilinear resize)."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, split) if split else root
    yy, xx = np.mgrid[:size, :size]
    for name in names:
        fdir = os.path.join(base, name, "Frame")
        gdir = os.path.join(base, name, "GT")
        os.makedirs(fdir)
        os.makedirs(gdir)
        for i in range(n_frames):
            img = rng.integers(0, 255, (size, size, 3), np.uint8)
            Image.fromarray(img).save(os.path.join(fdir, f"{i * 3}.{ext}"))
            cy, cx = rng.integers(12, size - 12, 2)
            d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
            m = np.clip((9.0 - d) * 80, 0, 255).astype(np.uint8)
            Image.fromarray(m).save(os.path.join(gdir, f"{i * 3}.png"))
    return root


@pytest.fixture(scope="module")
def polyp_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("polyp"))
    _polyp_tree(root, names=("vid0", "Kvasir_1"), n_frames=7)
    return root


@pytest.mark.parametrize("augment,epoch", [(False, 0), (True, 0), (True, 2)])
def test_polyp_clips_equal_jax(polyp_root, augment, epoch):
    want = jpolyp.PolypDataset(polyp_root, 36, clip_len=5, augment=augment,
                               seed=7)
    got = tpolyp.PolypDataset(polyp_root, 36, clip_len=5, augment=augment,
                              seed=7)
    assert got.samples == want.samples and len(got) == 14
    want.set_epoch(epoch)
    got.set_epoch(epoch)
    for i in range(len(want)):
        out = got.load_clip(i)
        _assert_same(out, want.load_clip(i))
    assert out["clip"].shape == (5, 36, 36, 3)
    assert 0.0 < out["masks"].max() <= 1.0
    assert set(np.unique(out["edges"])) <= {0.0, 1.0}


def test_polyp_sort_and_centered_windows_equal_jax(polyp_root):
    ds = tpolyp.PolypDataset(polyp_root, 36, clip_len=5, augment=False)
    # vid0 sorts by number, Kvasir_1 lexically (data_polyp.py:169-172)
    kvasir = [os.path.basename(p) for p in ds.samples[0][0]]
    vid0 = [os.path.basename(p) for p in ds.samples[7][0]]
    assert kvasir == ["0.jpg", "0.jpg", "0.jpg", "12.jpg", "15.jpg"]
    assert vid0 == ["0.jpg", "0.jpg", "0.jpg", "3.jpg", "6.jpg"]
    # the window at the far end clamps to the last frame
    last = [os.path.basename(p) for p in ds.samples[13][0]]
    assert last == ["12.jpg", "15.jpg", "18.jpg", "18.jpg", "18.jpg"]
    for n in (1, 2, 6, 9):
        for L in (1, 2, 3, 4, 5, 6):
            assert tpolyp.centered_windows(n, L) == \
                jpolyp.centered_windows(n, L), (n, L)


def _reference_test_tree(root, videos=("10", "2"), n_frames=3, size=40):
    """{root}/Frame/{video}/*.png with {root}/GT/{video}/*.png: the
    reference's test layout, videos sorted by number."""
    rng = np.random.default_rng(1)
    for vid in videos:
        for sub in ("Frame", "GT"):
            os.makedirs(os.path.join(root, sub, vid))
        for i in range(n_frames):
            img = rng.integers(0, 255, (size, size, 3), np.uint8)
            Image.fromarray(img).save(os.path.join(root, "Frame", vid,
                                                   f"{i}.png"))
            m = (rng.random((size, size)) < 0.3).astype(np.uint8) * 255
            Image.fromarray(m).save(os.path.join(root, "GT", vid, f"{i}.png"))
    return root


@pytest.mark.parametrize("layout", ["reference", "flat", "train_style"])
def test_polyp_test_dataset_equal_jax(tmp_path, layout):
    root = str(tmp_path)
    if layout == "reference":
        _reference_test_tree(root)
    elif layout == "flat":  # {root}/Frame/*.jpg beside {root}/GT/*.png
        _polyp_tree(root, split=None, names=("v",), n_frames=4)
        root = os.path.join(root, "v")
    else:  # {root}/{video}/Frame/
        _polyp_tree(root, split=None, names=("a", "b"), n_frames=3)
    want = jpolyp.PolypTestDataset(root, 32, clip_len=3)
    got = tpolyp.PolypTestDataset(root, 32, clip_len=3)
    assert got.samples == want.samples and len(got) > 0
    if layout == "reference":
        assert [os.path.basename(os.path.dirname(s[0][0]))
                for s in got.samples] == ["2"] * 3 + ["10"] * 3
    for i in range(len(want)):
        _assert_same(got.load_clip(i), want.load_clip(i))


def test_loader_batches_equal_jax(polyp_root, otu_root):
    """The loaders over both datasets: the same order, augmentation draws
    and batches, two threads each."""
    for jds, tds in (
            (jpolyp.PolypDataset(polyp_root, 32, clip_len=3, seed=1),
             tpolyp.PolypDataset(polyp_root, 32, clip_len=3, seed=1)),
            (jotu.OTUDataset(otu_root, 32, seed=1),
             totu.OTUDataset(otu_root, 32, seed=1))):
        want = jloader.DataLoader(jds, 2, num_workers=2, seed=5)
        got = tloader.DataLoader(tds, 2, num_workers=2, seed=5)
        for epoch in (0, 1):
            want.set_epoch(epoch)
            got.set_epoch(epoch)
            pairs = list(zip(got, want, strict=True))
            assert len(pairs) == len(want) > 0
            for g, w in pairs:
                _assert_same(g, w)
