"""The PyTorch port's Trainer on the CPU: ``fit`` runs, validates with the
JAX Trainer's metric keys, checkpoints, and restores the whole train
state; the Trainer refuses the CPU unless it is asked for it."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from vivim_tpu.nn.vivim import Vivim as JVivim
from vivim_tpu.nn.vivim import VivimConfig as JConfig
from vivim_tpu.train.logging import MetricLogger as JLogger
from vivim_tpu.train.trainer import Trainer as JTrainer
from vivim_tpu.train.trainer import TrainerConfig as JTrainerConfig
from vivim_tpu_torch.nn.layers import init_weights
from vivim_tpu_torch.nn.vivim import Vivim, VivimConfig
from vivim_tpu_torch.train.logging import MetricLogger
from vivim_tpu_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)


class Loader:
    """In-memory loader of numpy batch dicts."""

    def __init__(self, batches):
        self.batches = batches
        self.epochs = []

    def set_epoch(self, epoch):
        self.epochs.append(epoch)

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def _batches(n, seed, B=1, T=2, S=32, C=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        labels = rng.integers(0, C, (B, T, S, S))
        labels[:, :, :8] = 0
        out.append({"clip": rng.standard_normal((B, T, S, S, 3)).astype(
                        np.float32),
                    "masks": np.eye(C, dtype=np.float32)[labels],
                    "paths": [["frame"] * T] * B})
    return out


def _trainer(tmp_path, name, **kw):
    model = init_weights(Vivim(VivimConfig.micro_test(scan_implementation=None)),
                         torch.Generator().manual_seed(0))
    cfg = TrainerConfig(epochs=1, lr=1e-3, log_every=1, device="cpu", **kw)
    return Trainer(model, cfg, Loader(_batches(2, 0)), Loader(_batches(1, 1)),
                   str(tmp_path / name / "ckpt"),
                   MetricLogger(str(tmp_path / name / "logs")))


def test_fit_checkpoints_and_restores(tmp_path):
    trainer = _trainer(tmp_path, "a")
    best = trainer.fit()
    assert trainer.state.step == 2 and trainer.epoch == 1
    assert trainer.train_loader.epochs == [0]
    assert best is not None and 0.0 <= best <= 1.0
    last = trainer.ckpt.last_path()
    assert last.endswith("last_2.pt") and trainer.ckpt.best_path()
    with open(trainer.logger.path) as f:
        records = f.read()
    assert "train/grad_norm" in records and "val/dice" in records

    fresh = _trainer(tmp_path, "b")
    fresh.resume(last)
    assert fresh.state.step == 2 and fresh.epoch == 1
    assert fresh.state.opt.count == 2
    for (k, v), w in zip(fresh.model.state_dict().items(),
                         trainer.model.state_dict().values()):
        assert torch.equal(v, w), k
    for a, b in zip(fresh.state.opt.mu + fresh.state.opt.nu,
                    trainer.state.opt.mu + trainer.state.opt.nu):
        assert torch.equal(a, b)
    assert torch.equal(fresh.state.generator.get_state(),
                       trainer.state.generator.get_state())
    assert fresh.fit() is None  # nothing left to do: already at the end


def test_validate_has_the_jax_trainers_metric_keys(tmp_path):
    trainer = _trainer(tmp_path, "p")
    metrics, _, cm = trainer.validate()
    assert int(cm.sum()) == 2 * 32 * 32

    jcfg = JConfig.micro_test()
    jt = JTrainer(JVivim(jcfg), JTrainerConfig(epochs=1),
                  Loader(_batches(2, 0)), Loader(_batches(1, 1)),
                  str(tmp_path / "j" / "ckpt"), JLogger(str(tmp_path / "j")))
    jmetrics, _, _ = jt.validate()
    assert set(metrics) == set(jmetrics)


def test_trainer_refuses_what_it_has_not_got(tmp_path, capsys):
    # ZeRO without a data axis of more than one rank: the JAX message
    with pytest.raises(ValueError, match="-n_devices N"):
        _trainer(tmp_path, "z", zero=True)
    # no wandb here: the logger says so and writes JSONL only, as the JAX
    # package's does
    logger = MetricLogger(str(tmp_path / "w"), use_wandb=True,
                          config={"a": 1})
    logger.log({"train/loss": 0.5}, step=1)
    logger.finish()
    assert logger.wandb is None
    assert "wandb unavailable" in capsys.readouterr().out
    with open(logger.path) as f:
        assert len(f.readlines()) == 2
