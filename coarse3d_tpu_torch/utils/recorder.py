"""Run recorder: directories, logging, metric writer, code snapshot.

The port's copy of the JAX package's ``utils/recorder.py``. Behavioral
model: the reference's pc_processor/checkpoint/recorder.py:9-93 —
creates save_path/{code,log,checkpoint,events}, file+stdout logger,
tensorboard writer, snapshots the source tree into the run dir, dumps the
settings. Rank-0 only (main.py:46-50): the caller passes ``enabled``.

The metric writer is JSONL-first (one {"tag", "value", "step"} record per
line, trivially machine-readable for other tools) with tensorboardX
mirroring when available.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import sys
import time


class MetricWriter:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._tb = None

    def scalar(self, tag: str, value: float, step: int):
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step),
             "ts": time.time()}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def image(self, tag: str, image, step: int):
        """image: (H, W, 3) float [0,1] or uint8."""
        if self._tb is not None:
            self._tb.add_image(tag, image, step, dataformats="HWC")

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class Recorder:
    def __init__(self, save_path: str, settings=None,
                 snapshot_code_root: str | None = None,
                 use_tensorboard: bool = True, enabled: bool = True):
        self.enabled = enabled
        self.save_path = save_path
        self.logger = logging.getLogger("coarse3d_tpu_torch")
        self.logger.setLevel(logging.INFO)
        self.logger.handlers.clear()
        fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        self.logger.addHandler(sh)
        if not enabled:
            self.writer = None
            return

        for sub in ("checkpoint", "log", "code"):
            os.makedirs(os.path.join(save_path, sub), exist_ok=True)
        fh = logging.FileHandler(
            os.path.join(save_path, "log", "console.log"))
        fh.setFormatter(fmt)
        self.logger.addHandler(fh)
        self.writer = MetricWriter(
            os.path.join(save_path, "log"), use_tensorboard)

        if settings is not None:
            with open(os.path.join(save_path, "settings.json"), "w") as f:
                if dataclasses.is_dataclass(settings):
                    settings = dataclasses.asdict(settings)
                json.dump(settings, f, indent=2, default=str)

        if snapshot_code_root:
            self._snapshot_code(snapshot_code_root)

    def _snapshot_code(self, root: str):
        """Copy .py/.yaml/.sh sources into the run dir (recorder.py:70-88)."""
        dst_root = os.path.join(self.save_path, "code")
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames if not d.startswith(".")
                           and d not in ("__pycache__", "experiments")]
            for fname in filenames:
                if fname.endswith((".py", ".yaml", ".sh", ".toml")):
                    src = os.path.join(dirpath, fname)
                    rel = os.path.relpath(src, root)
                    dst = os.path.join(dst_root, rel)
                    os.makedirs(os.path.dirname(dst), exist_ok=True)
                    shutil.copy2(src, dst)

    def scalar(self, tag: str, value: float, step: int):
        if self.writer is not None:
            self.writer.scalar(tag, value, step)

    def image(self, tag: str, image, step: int):
        if self.writer is not None:
            self.writer.image(tag, image, step)

    def close(self):
        """Flush and close the metric writer and detach log handlers (long
        multi-run processes — e.g. tools/contrast_ablation.py — would
        otherwise accumulate duplicate handlers and open files)."""
        if self.writer is not None:
            self.writer.close()
            self.writer = None
        for h in list(self.logger.handlers):
            self.logger.removeHandler(h)
            try:
                h.close()
            except Exception:
                pass
