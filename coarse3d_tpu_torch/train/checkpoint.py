"""Checkpoint / resume on ``torch.save``.

Port of the JAX package's ``train/checkpoint.py`` (Orbax there). Behavioral
model: the reference's three flavors: a rolling checkpoint per epoch with
{model, optimizer, scheduler, epoch} (main.py:148-159), best-metric
snapshots per metric key (main.py:124-145), and one-way pretrained encoder
loads (trainer.py:69-106).

A checkpoint is one file, ``<save_path>/checkpoint/epoch_<NNNN>.pth`` or
``best_<key>.pth``, holding the model's state dict, the optimizer's, the
scheduler's, the prototype memory, ``step``, ``epoch`` and the state of the
generator the step draws its noise and dropout masks from, so a resumed
run draws what the unbroken run would. It is written under a temporary name
and moved into place, so a killed run leaves no half-written file. A
generator's state belongs to its kind of device: a checkpoint saved on the
CPU restores everything but the generator on a card (and the other way
round), which evaluation does not need.
"""

from __future__ import annotations

import os
import re
from typing import Any

import torch

from coarse3d_tpu_torch.train.state import TrainState

_ROLLING = re.compile(r"^epoch_(\d+)\.pth$")


def _to_saveable(state: TrainState, epoch: int) -> dict[str, Any]:
    return {
        "step": int(state.step),
        "epoch": int(epoch),
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "scheduler": state.scheduler.state_dict(),
        "prototypes": state.prototypes,
        "generator": state.generator.get_state(),
        "generator_device": state.generator.device.type,
    }


def _save(path: str, payload: dict[str, Any]) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _load_into(state: TrainState, path: str) -> int:
    """Load the checkpoint at ``path`` into ``state`` in place, on the
    state's device; returns the saved epoch."""
    dev = state.device
    # onto the CPU first: load_state_dict moves weights and moments to
    # their parameters' device, and AdamW's step counts must stay host
    # tensors (on the card every optimizer step would read them back)
    data = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(data["model"], strict=True)
    state.optimizer.load_state_dict(data["optimizer"])
    state.scheduler.load_state_dict(data["scheduler"])
    state.prototypes = data["prototypes"].to(dev, torch.float32)
    state.step = int(data["step"])
    if data["generator_device"] == state.generator.device.type:
        state.generator.set_state(data["generator"].cpu())
    return int(data["epoch"])


class CheckpointManager:
    """Rolling + best-metric checkpoints under <save_path>/checkpoint.

    ``write=False`` keeps the bookkeeping (which metrics improved) and
    writes no file: the ranks of a multi-GPU run other than 0 hold the
    same state as rank 0, which alone writes it."""

    def __init__(self, save_path: str, max_to_keep: int = 2,
                 write: bool = True):
        self.root = os.path.abspath(os.path.join(save_path, "checkpoint"))
        os.makedirs(self.root, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.write = write
        self._best: dict[str, float] = {}

    def _rolling_epochs(self) -> list[int]:
        return sorted(int(m[1]) for m in map(_ROLLING.match,
                                             os.listdir(self.root)) if m)

    def _rolling_path(self, epoch: int) -> str:
        return os.path.join(self.root, f"epoch_{epoch:04d}.pth")

    def save_rolling(self, state: TrainState, epoch: int) -> None:
        if not self.write:
            return
        _save(self._rolling_path(epoch), _to_saveable(state, epoch))
        for old in self._rolling_epochs()[:-self.max_to_keep]:
            os.remove(self._rolling_path(old))

    def save_best(self, state: TrainState, epoch: int, metrics: dict
                  ) -> list[str]:
        """Keep best_<key> snapshots when a tracked metric improves
        (main.py:124-145 semantics, keys e.g. 3DAcc / 3DIOU)."""
        improved = []
        payload = None
        for key, value in metrics.items():
            if value > self._best.get(key, float("-inf")):
                self._best[key] = value
                improved.append(key)
                if not self.write:
                    continue
                if payload is None:
                    payload = _to_saveable(state, epoch)
                _save(os.path.join(self.root, f"best_{key}.pth"), payload)
        return improved

    def latest_epoch(self) -> int | None:
        epochs = self._rolling_epochs()
        return epochs[-1] if epochs else None

    def restore_best(self, state: TrainState, key: str = "3DIOU"
                     ) -> TrainState:
        """Restore a best_<key> snapshot (main.py:124-145's best model);
        the published BASELINE numbers are best-checkpoint numbers."""
        path = os.path.join(self.root, f"best_{key}.pth")
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"no best_{key} snapshot under {self.root} (run had no "
                "validation epochs?): use the rolling checkpoint instead")
        _load_into(state, path)
        return state

    def restore(self, state: TrainState, epoch: int | None = None
                ) -> tuple[TrainState, int]:
        """Restore a rolling checkpoint (the latest by default) into
        ``state`` in place; returns (state, start_epoch)."""
        if epoch is None:
            epoch = self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoint found under {self.root}")
        return state, _load_into(state, self._rolling_path(epoch)) + 1

    def close(self) -> None:
        """Nothing to release: every save is finished when it returns. Kept
        for the JAX package's call sites."""


def restore_from_run_dir(state: TrainState, run_dir: str,
                         ckpt: str = "latest") -> TrainState:
    """Restore a tools-CLI checkpoint selection into ``state``.

    ``ckpt`` is the CLI spelling: 'latest' (rolling) or a best-metric key
    like 'best_3DIOU' / '3DIOU'. Shared by the tools that take
    --run_dir/--ckpt, which must resolve them identically."""
    mgr = CheckpointManager(run_dir)
    if ckpt == "latest":
        state, _ = mgr.restore(state)
    else:
        state = mgr.restore_best(state, key=ckpt.removeprefix("best_"))
    return state


def load_pretrained_params(
    state: TrainState, params_like: dict[str, torch.Tensor],
    only_prefixes: tuple[str, ...] = ()
) -> tuple[TrainState, int]:
    """Shape-and-name-filtered pretrained load (trainer.py:87-102): copy
    any entry of a reference-named state dict whose name exists in the
    model's state dict with the same shape (weights and BatchNorm
    statistics alike, as the reference's ``load_state_dict`` of the
    filtered dict does); optionally only names starting with the given
    prefixes (the encoder_module.yaml analog). Returns (state, copied)."""
    current = state.model.state_dict()
    copied = 0
    with torch.no_grad():
        for key, val in params_like.items():
            if only_prefixes and not key.startswith(only_prefixes):
                continue
            if key in current and current[key].shape == val.shape:
                current[key].copy_(val)
                copied += 1
    return state, copied
