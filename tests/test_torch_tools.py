"""The port's host tools against the JAX package's: ``cli/check_data``
(the same lines for the same tree; the figure, or a line saying why not),
``cli/bench_loader`` (the same synthetic tree, ``measure_loader`` and
``measure_stages`` on a tiny tree, ``main``'s JSON line with the JAX
keys) and ``utils/profiling`` (a trace written on the CPU, the same
``step_timer`` summary, the Trainer's ``profile_dir`` through it)."""

import glob
import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from tests.data_fixtures import make_gathered_tree
from vivim_tpu.cli import bench_loader as jbench_loader
from vivim_tpu.cli import check_data as jcheck_data
from vivim_tpu.utils import profiling as jprofiling
from vivim_tpu_torch.cli import bench_loader, check_data
from vivim_tpu_torch.utils import profiling

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_gathered_tree(str(tmp_path_factory.mktemp("tree")),
                              n_videos=2, n_frames=6, size=40)


@pytest.mark.parametrize("binary", [False, True])
def test_check_data_prints_the_jax_lines(tree, tmp_path, capsys, binary):
    argv = [tree, "--image_size", "32", "--out", str(tmp_path / "fig.png")]
    argv += ["--binary"] if binary else []
    jcheck_data.main(argv)
    want = capsys.readouterr().out
    os.remove(tmp_path / "fig.png")
    check_data.main(argv)
    got = capsys.readouterr().out
    assert got == want
    assert len(got.splitlines()) == 8
    assert Image.open(tmp_path / "fig.png").size[0] > 0


def test_check_data_without_matplotlib(tree, tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = tmp_path / "fig.png"
    check_data.main([tree, "--image_size", "32", "--out", str(out)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == ("matplotlib cannot be imported: not writing the "
                         f"alignment figure {out}")
    assert not out.exists()


def test_bench_loader_synthetic_tree_equals_jax(tmp_path):
    for mod, sub in ((bench_loader, "port"), (jbench_loader, "jax")):
        mod.make_synthetic_tree(str(tmp_path / sub), n_videos=2, n_frames=3,
                                size=32)
    files = sorted(os.path.relpath(p, tmp_path / "jax") for p in
                   glob.glob(str(tmp_path / "jax" / "*" / "*.png")))
    assert len(files) == 2 * 3 * 3
    assert files == sorted(os.path.relpath(p, tmp_path / "port") for p in
                           glob.glob(str(tmp_path / "port" / "*" / "*.png")))
    for f in files:
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "port" / f)),
            np.asarray(Image.open(tmp_path / "jax" / f)), err_msg=f)


def test_bench_loader_measures_a_tiny_tree(tree):
    kw = dict(data_root=tree, image_size=32, clip_length=3)
    got = bench_loader.measure_loader(batch_size=2, num_workers=2, **kw)
    want = jbench_loader.measure_loader(batch_size=2, num_workers=2, **kw)
    assert set(got) == set(want)
    assert got["frames"] == want["frames"] == 4 * 3  # 2 batches of 2 clips
    assert got["frames_per_sec"] > 0
    stages = bench_loader.measure_stages(n_clips=2, **kw)
    assert set(stages) == set(jbench_loader.measure_stages(n_clips=2, **kw))
    assert stages["frames_measured"] == 6


def test_bench_loader_main_prints_the_jax_json_line(tree, capsys):
    argv = ["--data_root", tree, "--image_size", "32", "--clip_length", "3",
            "--batch_size", "2", "--epochs", "1", "--per_stage"]
    assert bench_loader.main(argv) == 0
    got = capsys.readouterr().out.splitlines()
    jbench_loader.main(argv)
    want = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 1
    got, want = json.loads(got[0]), json.loads(want[0])
    assert set(got) == set(want) and got["metric"] == want["metric"]
    assert set(got["per_stage"]) == set(want["per_stage"])


def test_trace_writes_a_trace_on_the_cpu(tmp_path):
    with profiling.trace(str(tmp_path)):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)


def test_step_timer_summary_has_the_jax_keys():
    timers = [profiling.step_timer(), jprofiling.step_timer()]
    for t in timers:
        assert t.summary() == {}
        for _ in range(3):
            with t:
                pass
    got, want = (t.summary() for t in timers)
    assert set(got) == set(want) and got["steps"] == 3


def test_trainer_profile_dir_writes_a_trace(tmp_path):
    """The Trainer's ``profile_dir`` goes through ``profiling.trace``: steps
    1.. of the first epoch, one trace file."""
    from vivim_tpu_torch.nn.layers import init_weights
    from vivim_tpu_torch.nn.vivim import Vivim, VivimConfig
    from vivim_tpu_torch.train.logging import MetricLogger
    from vivim_tpu_torch.train.trainer import Trainer, TrainerConfig

    rng = np.random.default_rng(0)
    batches = [{"clip": rng.standard_normal((1, 2, 32, 32, 3)).astype(
                    np.float32),
                "masks": np.eye(3, dtype=np.float32)[
                    rng.integers(0, 3, (1, 2, 32, 32))]} for _ in range(3)]
    model = init_weights(Vivim(VivimConfig.micro_test()),
                         torch.Generator().manual_seed(0))
    trainer = Trainer(
        model, TrainerConfig(epochs=1, device="cpu", profile_steps=1,
                             profile_dir=str(tmp_path / "prof")),
        batches, [], str(tmp_path / "ckpt"),
        MetricLogger(str(tmp_path / "logs")))
    trainer.fit()
    files = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    assert sum(e.get("name") == "aten::conv3d" for e in events) >= 1
