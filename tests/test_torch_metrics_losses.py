"""The rest of the port's ``train/metrics.py`` and the legacy VOS losses of
its ``train/losses.py`` against the JAX package's.

- Every name of the JAX ``ALL_METRICS`` is in the port's; each confusion
  metric gives the JAX value exactly (NaN where JAX gives NaN) on seeded
  counts and on the empty / full edge cases, with and without
  ``nan_for_nonexisting``; the surface distances give the JAX values on
  seeded 2-D and 3-D masks and on empty ones.
- ``mask_iou``, ``mask_iou_loss``, ``binary_entropy_loss``,
  ``cross_entropy_loss`` and ``smooth_l1_loss`` on seeded numpy inputs, with
  and without ``ref``, at the JAX suite's rtol 1e-5 (tests/test_losses.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vivim_tpu.train import losses as JL
from vivim_tpu.train import metrics as JM
from vivim_tpu_torch.train import losses as L
from vivim_tpu_torch.train import metrics as M

torch.set_num_threads(1)

SURFACE = ("hausdorff_distance", "hausdorff_distance_95",
           "avg_surface_distance", "avg_surface_distance_symmetric")


def _counts():
    """Seeded (tp, fp, tn, fn) tuples and every zero pattern of the four."""
    rng = np.random.default_rng(0)
    seeded = [tuple(int(v) for v in rng.integers(0, 50, 4)) for _ in range(8)]
    zeros = [tuple(int(v) * 7 for v in np.unravel_index(i, (2,) * 4))
             for i in range(16)]
    return seeded + zeros


def test_all_metrics_has_every_jax_name():
    assert set(M.ALL_METRICS) == set(JM.ALL_METRICS)
    assert set(M.CONFUSION_METRICS) == set(JM.CONFUSION_METRICS)


def _same(got, want):
    if isinstance(want, float) and np.isnan(want):
        assert np.isnan(got)
    else:
        assert got == want and type(got) is type(want)


@pytest.mark.parametrize("name", sorted(JM.CONFUSION_METRICS))
def test_confusion_metric_equals_jax(name):
    for counts in _counts():
        for nan in (False, True):
            kw = {"nan_for_nonexisting": nan}
            if counts == (0, 0, 0, 0) and name == "accuracy":
                continue  # 0 / 0 in both: a ZeroDivisionError
            _same(M.CONFUSION_METRICS[name](*counts, **kw),
                  JM.CONFUSION_METRICS[name](*counts, **kw))


@pytest.mark.parametrize("name", SURFACE)
def test_surface_distance_equals_jax(name):
    rng = np.random.default_rng(1)
    cases = []
    for shape in ((24, 24), (6, 16, 16)):
        a = rng.random(shape) < 0.3
        b = np.roll(a, 2, axis=-1) | (rng.random(shape) < 0.05)
        cases += [(a, b), (b, a), (a, a), (a, np.zeros(shape, bool))]
    for test, ref in cases:
        for nan in (False, True):
            _same(M.ALL_METRICS[name](test, ref, nan_for_nonexisting=nan),
                  JM.ALL_METRICS[name](test, ref, nan_for_nonexisting=nan))


@pytest.mark.parametrize("with_ref", [False, True])
def test_legacy_vos_losses_equal_jax(with_ref):
    rng = np.random.default_rng(7)
    N, K, H, W = 3, 4, 16, 16
    num_object = 3  # K != num_object: the background channel is skipped
    pred = rng.uniform(0.01, 0.99, (N, K, H, W)).astype(np.float32)
    pred = pred / pred.sum(1, keepdims=True)
    mask = np.eye(K, dtype=np.float32)[
        rng.integers(0, K, (N, H, W))].transpose(0, 3, 1, 2)
    ref = None
    if with_ref:
        ref = (rng.random((N, K, H, W)) < 0.3).astype(np.float32)
        ref[0, 1] = 0.0  # a fully absent channel exercises the gating
    j = jnp.asarray
    t = torch.from_numpy
    jref = None if ref is None else j(ref)
    tref = None if ref is None else t(ref)
    pairs = [
        (L.mask_iou(t(pred[:, 0]), t(mask[:, 0])),
         JL.mask_iou(j(pred[:, 0]), j(mask[:, 0]))),
        (L.mask_iou(t(pred[:, 0]), t(mask[:, 0]), averaged=False),
         JL.mask_iou(j(pred[:, 0]), j(mask[:, 0]), averaged=False)),
        (L.mask_iou_loss(t(pred), t(mask), num_object, ref=tref),
         JL.mask_iou_loss(j(pred), j(mask), num_object, ref=jref)),
        # K == num_object: no background channel to skip
        (L.mask_iou_loss(t(pred[:, 1:]), t(mask[:, 1:]), num_object,
                         ref=None if ref is None else t(ref[:, 1:])),
         JL.mask_iou_loss(j(pred[:, 1:]), j(mask[:, 1:]), num_object,
                          ref=None if ref is None else j(ref[:, 1:]))),
        (L.cross_entropy_loss(t(pred), t(mask), num_object, ref=tref),
         JL.cross_entropy_loss(j(pred), j(mask), num_object, ref=jref)),
        (L.binary_entropy_loss(t(pred[:, 0]), t(mask[:, 0])),
         JL.binary_entropy_loss(j(pred[:, 0]), j(mask[:, 0]))),
    ]
    x = (0.1 * rng.standard_normal((N, H, W))).astype(np.float32)
    y = (0.1 * rng.standard_normal((N, H, W))).astype(np.float32)
    pairs.append((L.smooth_l1_loss(t(x), t(y)), JL.smooth_l1_loss(j(x),
                                                                  j(y))))
    for i, (got, want) in enumerate(pairs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   err_msg=str(i))
