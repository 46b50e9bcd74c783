"""The control fails each cell's output check on the card: the plain
reference computed with TF32 (one precision below the configurations'
float32) in the program's place, at the cell's own sizes, on three seeds,
must fail at least one of the cell's numbers under the committed limits.
Needs the card (``cuda`` marker; skips without one):
``python -m pytest perfbench/test_perfbench_control.py -q``."""

import pathlib

import pytest
import torch

from perfbench import control, harness

REPO = pathlib.Path(harness.HERE).parent
BENCH = harness.load_json(REPO / "BENCHMARK.json")
SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the control runs the reference on the card (TF32 is a "
                    "CUDA precision)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_the_control_fails_the_check(card, cell):
    for seed in SEEDS:
        checks = control.control(BENCH, cell, str(REPO), harness.HERE, seed,
                                 "cuda")
        print(cell, seed, {c.name: c.value for c in checks})
        assert not all(c.ok for c in checks), [
            (c.name, c.value, c.limit) for c in checks]
