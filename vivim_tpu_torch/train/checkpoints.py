"""Checkpointing with the reference's monitor semantics, on ``torch.save``.

Port of the JAX package's ``train/checkpoints.py`` (orbax there):
- k-fold training monitors ``val/dice``, mode max, top-1, plus the last
  state (multiclass_training_folds.py:788-797);
- the final retrain monitors ``train/loss``, mode min, top-3
  (final_multiclass_training.py:768-777);
- ``restore`` brings back the whole train state: the model's parameters and
  BatchNorm statistics, the optimizer moments and count, the step and the
  generator.

A checkpoint is one file, ``best_<step>.pt`` or ``last_<step>.pt``, written
to a temporary name and renamed, so a crash never leaves a partial file.
``save_params`` / ``load_params`` export and read a model's state_dict alone
(the ``-pretrain`` weights), and ``load_params`` also reads the model out of
a manager's checkpoint.
"""

from __future__ import annotations

import json
import os

import torch


def _save_atomic(obj, path):
    path = os.path.abspath(path)
    tmp = os.path.join(os.path.dirname(path), f".{os.path.basename(path)}.tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_params(path: str, state_dict):
    """Write a model's state_dict to ``path``."""
    _save_atomic(dict(state_dict), path)


def load_params(path: str):
    """The model state_dict of a ``save_params`` file or of a
    ``CheckpointManager`` checkpoint, on the CPU."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and {"step", "model", "opt"} <= set(obj):
        return obj["model"]
    return obj


def _state_dict(state):
    return {"step": state.step, "model": state.model.state_dict(),
            "opt": state.opt.state_dict(),
            "generator": state.generator.get_state()}


class CheckpointManager:
    """Top-k checkpoints keyed on a monitored metric, plus the last one."""

    def __init__(self, directory: str, monitor: str = "val/dice",
                 mode: str = "max", top_k: int = 1, save_last: bool = True):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.monitor, self.mode = monitor, mode
        self.top_k, self.save_last = top_k, save_last
        self._scores: list[tuple[float, int]] = []  # (score, step)
        self._meta_path = os.path.join(self.directory, "manager.json")
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                self._scores = [tuple(s) for s in json.load(f)["scores"]]

    def _path(self, name):
        return os.path.join(self.directory, name)

    def _steps(self, prefix):
        """Steps of the ``<prefix><step>.pt`` files present."""
        out = []
        for d in os.listdir(self.directory):
            rest = d[len(prefix):-len(".pt")]
            if d.startswith(prefix) and d.endswith(".pt") and rest.isdigit():
                out.append(int(rest))
        return sorted(out)

    def _write(self, name, state):
        _save_atomic(_state_dict(state), self._path(name))

    def save(self, state, step: int, metrics: dict) -> bool:
        """Save ``last_<step>`` (and drop older ones), and ``best_<step>``
        when the monitored metric ranks in the top k; returns whether it
        did the latter."""
        if self.save_last:
            self._write(f"last_{step}.pt", state)
            for s in self._steps("last_"):
                if s != step:
                    os.remove(self._path(f"last_{s}.pt"))
        score = metrics.get(self.monitor)
        if score is None:
            return False
        self._scores.append((float(score), step))
        self._scores.sort(key=lambda s: s[0], reverse=(self.mode == "max"))
        keep = self._scores[: self.top_k]
        saved = (float(score), step) in keep
        if saved:
            self._write(f"best_{step}.pt", state)
        keep_steps = {s for _, s in keep}
        for s in self._steps("best_"):
            if s not in keep_steps:
                os.remove(self._path(f"best_{s}.pt"))
        self._scores = keep
        with open(self._meta_path, "w") as f:
            json.dump({"scores": self._scores, "monitor": self.monitor,
                       "mode": self.mode}, f)
        return saved

    def best_path(self):
        if not self._scores:
            return None
        return self._path(f"best_{self._scores[0][1]}.pt")

    def last_path(self):
        steps = self._steps("last_")
        return self._path(f"last_{steps[-1]}.pt") if steps else None

    def restore(self, state, path: str | None = None):
        """Load a checkpoint (default: the newest last, else the best) into
        ``state`` in place and return it."""
        path = path or self.last_path() or self.best_path()
        if path is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        dev = next(state.model.parameters()).device
        obj = torch.load(path, map_location=dev, weights_only=True)
        state.model.load_state_dict(obj["model"])
        state.opt.load_state_dict(obj["opt"])
        state.generator.set_state(obj["generator"].cpu())
        state.step = int(obj["step"])
        return state
