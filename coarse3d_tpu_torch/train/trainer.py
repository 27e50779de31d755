"""Epoch-driving Trainer.

Port of the JAX package's ``train/trainer.py``. Behavioral model:
tasks/weak_segmentation/{main.py:14-175, trainer.py:17-899}: per-epoch
train/val loops with DT/PT timing, contrast gating from the warmup epoch,
epoch-growing pseudo-label keep ratio, 3D confusion metrics, per-class IoU
logging, best-metric + rolling checkpoints.

Design on the card: the loop body is one of two step functions (warmup /
contrast) that enqueue their kernels and return; batches stream from the
host pipeline in page-locked memory and are copied asynchronously;
confusion matrices, loss sums and prototype diagnostics accumulate on the
device, and the host reads loss values only at logging intervals
(``i % 10 == 0``) and once at epoch end.

Across GPUs (``mesh``, the analog of the JAX Trainer's): one process per
card, each with its pipeline's stripe of every global batch. The steps
reduce over the global batch (``train/step.py``), so the training losses
and confusion are global already; each rank validates its own stripe and
the partial confusions are summed at the epoch's end. Only rank 0 writes
checkpoints (the recorder is switched off elsewhere by the caller,
``tools/train.py``).
"""

from __future__ import annotations

import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from coarse3d_tpu_torch.configs.config import ExperimentConfig
from coarse3d_tpu_torch.data.pipeline import BATCH_KEYS
from coarse3d_tpu_torch.device import resolve_device
from coarse3d_tpu_torch.metrics.iou import ConfusionState
from coarse3d_tpu_torch.parallel.mesh import all_reduce_sum, replicate_to_mesh
from coarse3d_tpu_torch.train.checkpoint import CheckpointManager
from coarse3d_tpu_torch.train.setup import build_alpha, build_state
from coarse3d_tpu_torch.train.step import (
    batch_to_device,
    make_eval_step,
    make_train_step,
    select_ratio_schedule,
)
from coarse3d_tpu_torch.utils import AverageMeter, Recorder, RemainTime
from coarse3d_tpu_torch.utils.profiling import (
    NO_SPAN,
    add_spans_to_chrome_trace,
    extend,
    host_sync_calls,
    span,
    traced_spans,
)


def _accumulate(sums: dict | None, values: dict) -> dict:
    if sums is None:
        return dict(values)
    return {k: sums[k] + v for k, v in values.items()}


class Trainer:
    def __init__(
        self,
        cfg: ExperimentConfig,
        train_pipe,
        val_pipe,
        recorder: Recorder | None = None,
        device: str | torch.device = "cuda",
        mesh=None,
    ):
        """``mesh`` (``parallel.mesh.make_mesh``) trains data-parallel on
        its device, which then stands in for ``device``; the pipelines
        must stripe by its rank and world size, the training one giving
        every rank the same number of steps."""
        self.cfg = cfg
        self.train_pipe = train_pipe
        self.val_pipe = val_pipe
        self.recorder = recorder or Recorder(cfg.save_path, enabled=False)
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(
            device)
        self.is_main = mesh is None or mesh.is_main
        self.steps_per_epoch = max(train_pipe.steps_per_epoch(), 1)
        if mesh is not None and mesh.world > 1:
            # a rank with one step more would wait in that step's
            # collectives for ranks that never enter them, and the
            # learning-rate schedule is built from this count
            span = torch.tensor([self.steps_per_epoch, -self.steps_per_epoch],
                                device=self.device)
            dist.all_reduce(span, dist.ReduceOp.MAX)
            if int(span[0]) != -int(span[1]):
                raise ValueError(
                    f"the ranks' training pipelines give {-int(span[1])} to "
                    f"{int(span[0])} steps an epoch: every rank must take "
                    f"the same number (DataPipeline's stripes do)")

        self.state = build_state(cfg, device=self.device,
                                 seed=cfg.train.seed,
                                 steps_per_epoch=self.steps_per_epoch)
        if mesh is not None:
            self.state = replicate_to_mesh(self.state, mesh)

        alpha = build_alpha(cfg)
        self._step_warmup = make_train_step(cfg, alpha, with_contrast=False,
                                            mesh=mesh)
        self._step_contrast = make_train_step(cfg, alpha, with_contrast=True,
                                              mesh=mesh)
        self._eval_step = make_eval_step(cfg, use_knn=cfg.train.val_use_knn)
        self._ratio = select_ratio_schedule(cfg.train.n_epochs)

        self.evaluator = ConfusionState(cfg.data.n_classes,
                                        ignore=(cfg.train.ignore_cls,))
        self.remain_time = RemainTime(cfg.train.n_epochs)
        self.ckpt = CheckpointManager(cfg.save_path, write=self.is_main)
        self.start_epoch = 0
        self.resumed: dict | None = None   # what maybe_resume restored
        # torch.profiler trace window: steps [first, last) of the training
        # epoch ``profile_epoch`` (the reference only logs DT/PT
        # wall-clock). The trace goes to <save_path>/profile/, the host's
        # waits for the card it shows to ``last_profile_syncs``.
        self.profile_steps: tuple[int, int] | None = None
        self.profile_epoch = 0
        self.last_profile_syncs: dict[str, int] | None = None
        # mean host seconds a step of the last epoch waited for its batch
        # (DT) and spent enqueueing it (PT), and the epoch's wall seconds
        self.last_epoch_timing: dict[str, float] = {}
        # one record per epoch run: mode, gating, results, timing
        self.history: list[dict] = []
        # preemption handling (the reference has none: crash recovery is
        # manual): SIGTERM/SIGINT request a graceful checkpoint at the next
        # epoch boundary
        self._stop_requested = False

    def install_signal_handlers(self):
        import signal

        def _handler(signum, frame):
            self.recorder.logger.warning(
                f"signal {signum}: will checkpoint and stop at the next "
                f"epoch boundary")
            self._stop_requested = True

        signal.signal(signal.SIGTERM, _handler)
        signal.signal(signal.SIGINT, _handler)

    def maybe_resume(self):
        if self.ckpt.latest_epoch() is not None:
            self.state, self.start_epoch = self.ckpt.restore(self.state)
            self.resumed = {
                "epoch": self.start_epoch - 1, "step": self.state.step,
                "lr": self.state.optimizer.param_groups[0]["lr"]}
            self.recorder.logger.info(
                f"resumed from epoch {self.start_epoch - 1} (step "
                f"{self.resumed['step']}, lr {self.resumed['lr']:.6g})")

    def _profile_window(self, prof, i: int):
        """Open the profiler at step ``first`` and close it at ``last``."""
        first, last = self.profile_steps
        if i == first and prof is None:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
        elif i == last and prof is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            prof.__exit__(None, None, None)
            out_dir = os.path.join(self.cfg.save_path, "profile")
            os.makedirs(out_dir, exist_ok=True)
            trace = os.path.join(out_dir, "trace.json")
            prof.export_chrome_trace(trace)
            add_spans_to_chrome_trace(trace, traced_spans())
            self.last_profile_syncs = host_sync_calls(prof)
            prof = None
        return prof

    # ------------------------------------------------------------------
    def run_epoch(self, epoch: int, mode: str = "Train") -> dict[str, float]:
        train = mode == "Train"
        pipe = self.train_pipe if train else self.val_pipe
        with_contrast = (
            train and epoch >= self.cfg.contrast.contrast_warmup
            and self.cfg.contrast.loss_w_contrast > 0)
        step_fn = self._step_contrast if with_contrast else self._step_warmup
        ratio = self._ratio(epoch) if with_contrast else 0.0
        sel_start = self.cfg.contrast.selection_warmup
        if sel_start is not None and epoch < sel_start:
            # staggered selection: ratio 0 == weak-only anchors (exactly:
            # entropy_based_selection keeps floor(0 * count) = 0 pseudo
            # pixels per segment and weak ground truth always wins)
            ratio = 0.0

        self.evaluator.reset()
        meters = {k: AverageMeter() for k in
                  ("total", "focal", "lovasz", "contrast")}
        total_iter = pipe.steps_per_epoch()
        log = self.recorder.logger
        # one clock read starts an epoch, DT and the spans of a step:
        # time.time_ns(), the clock of the profiler's own events
        t_epoch = t_start = t_open = time.time_ns()

        # Confusion AND loss scalars accumulate ON DEVICE; the host fetches
        # loss values only at logging intervals (for display) and once at
        # epoch end (for the true epoch averages): a host sync every step
        # (the reference does many .item()s per iter, trainer.py:749-762)
        # would serialize the asynchronous launches.
        last_panel = None
        device_conf = None
        device_loss_sums: dict | None = None
        device_diag_sums: dict | None = None
        n_steps = 0
        data_times, proc_times = [], []
        prof = None
        profiling = (self.profile_steps is not None and train
                     and epoch == self.profile_epoch)
        for i, host_batch in enumerate(pipe.epoch(epoch)):
            if profiling:
                prof = self._profile_window(prof, i)
            # spans (utils/profiling.py) of a training iteration:
            # train.step, its root, from the end of the last one;
            # train.data, the wait for the batch and its copy; the step's
            # own (train/step.py); train.log. Validation records none.
            step_span = (span("train.step", rid=self.state.step) if train
                         else NO_SPAN).open(t_open)
            data_span = (span("train.data") if train else NO_SPAN).open(t_open)
            # DT includes the copy to the card (with a mesh, the rank's
            # stripe to its card: parallel.mesh.shard_batch), as the JAX
            # Trainer's includes shard_batch, and the last step's log
            batch = batch_to_device(
                {k: host_batch[k] for k in BATCH_KEYS}, self.device)
            t_proc = time.time_ns()
            data_span.close(t_proc)
            data_time = (t_proc - t_start) * 1e-9

            if train:
                self.state, metrics = step_fn(self.state, batch, ratio)
                losses = metrics["losses"]
            else:
                metrics = self._eval_step(self.state, batch)
                losses = {}
                last_panel = (metrics["argmax_2d"],
                              host_batch["eval_label"][0],
                              host_batch["train_label"][0])

            conf = metrics["confusion"]
            device_conf = conf if device_conf is None else device_conf + conf
            if losses:
                n_steps += 1
                device_loss_sums = _accumulate(device_loss_sums, losses)
            diag = metrics.get("diag") if train else None
            if diag:
                device_diag_sums = _accumulate(device_diag_sums, diag)

            t_done = time.time_ns()
            extend("train.metrics", t_done)
            proc_time = (t_done - t_proc) * 1e-9
            data_times.append(data_time)
            proc_times.append(proc_time)
            self.remain_time.update((time.time_ns() - t_start) * 1e-9, mode)
            t_start = t_open = time.time_ns()

            if i % 10 == 0:
                log_span = (span("train.log") if train else NO_SPAN).open(
                    t_start)
                bsz = host_batch["features"].shape[0]
                loss_host = {k: float(v) for k, v in losses.items()}
                for k, v in loss_host.items():
                    if k in meters:
                        meters[k].update(v, bsz)
                eta = datetime.timedelta(seconds=int(
                    self.remain_time.get_remain_time(
                        epoch, i, total_iter, mode)))
                loss_str = " ".join(
                    f"{k}={v:.4f}" for k, v in loss_host.items())
                log.info(
                    f">>> {mode} E[{epoch + 1:03d}|"
                    f"{self.cfg.train.n_epochs:03d}] "
                    f"I[{i + 1:04d}|{total_iter:04d}] DT[{data_time:.3f}] "
                    f"PT[{proc_time:.3f}] {loss_str} RT[{eta}]")
                t_open = time.time_ns()
                log_span.close(t_open)
            step_span.close(t_open)
        if prof is not None:        # the epoch ended inside the window
            self._profile_window(prof, self.profile_steps[1])
        if not train and self.mesh is not None and self.mesh.world > 1:
            # each rank validated its own stripe (possibly none of it);
            # zeros of the eval step's confusion dtype (metrics/iou.py)
            if device_conf is None:
                n = self.cfg.data.n_classes
                device_conf = torch.zeros((n, n), dtype=torch.int32,
                                          device=self.device)
            device_conf = all_reduce_sum(device_conf, self.mesh)
        if device_conf is not None:
            self.evaluator.add(device_conf)
        # exact epoch-mean losses from the device accumulators (one fetch),
        # not the 10%-subsampled display meters
        epoch_loss = {
            k: float(v) / max(n_steps, 1)
            for k, v in (device_loss_sums or {}).items()}
        self.last_epoch_timing = {
            "steps": len(data_times),
            "data_s": float(np.mean(data_times)) if data_times else 0.0,
            # the first wait holds the prefetch threads' start-up
            "data_first_s": data_times[0] if data_times else 0.0,
            "data_later_s": (float(np.mean(data_times[1:]))
                             if len(data_times) > 1 else 0.0),
            "proc_s": float(np.mean(proc_times)) if proc_times else 0.0,
            "epoch_s": (time.time_ns() - t_epoch) * 1e-9,
        }
        if epoch_loss.get("lovasz_overflow", 0.0) > 0:
            # losses/lovasz.py:lovasz_budget_overflow: the budgeted sort
            # DROPPED valid pixels this epoch; the loss is no longer exact
            log.error(
                ">>> LOVASZ BUDGET OVERFLOW: mean %.1f valid pixels/step "
                "beyond train.lovasz_budget=%d were dropped: the Lovász "
                "loss is truncated; raise the budget.",
                epoch_loss["lovasz_overflow"], self.cfg.train.lovasz_budget)
        if last_panel is not None:
            last_panel = (last_panel[0][0].cpu().numpy(), last_panel[1],
                          last_panel[2])

        mean_iou, class_iou = self.evaluator.iou()
        mean_acc, _ = self.evaluator.acc()
        mean_recall, _ = self.evaluator.recall()
        class_iou = class_iou.numpy()
        results = {
            "3DIOU": float(mean_iou),
            "3DAcc": float(mean_acc),
            "3DRecall": float(mean_recall),
            # per-class IoU (incl. the ignore row) for consumers that track
            # rare-class behavior directly
            "class_IOU": [round(float(v), 4) for v in class_iou],
        }

        self.recorder.scalar(f"{mode}_mean_IOU_3D", results["3DIOU"], epoch)
        self.recorder.scalar(f"{mode}_mean_Acc_3D", results["3DAcc"], epoch)
        if train:
            for k, v in epoch_loss.items():
                if k in meters:
                    self.recorder.scalar(f"{mode}_Loss_{k}", v, epoch)
        if device_diag_sums is not None:
            # prototype-memory health (models/prototypes.py:
            # prototype_diagnostics): epoch means from device accumulators
            epoch_diag = {k: float(v) / max(n_steps, 1)
                          for k, v in device_diag_sums.items()}
            for k, v in epoch_diag.items():
                self.recorder.scalar(f"{mode}_{k}", v, epoch)
            log.info(">>> Epoch %d proto diag: %s", epoch + 1, " ".join(
                f"{k.removeprefix('proto_')}={v:.4f}"
                for k, v in epoch_diag.items()))
        class_names = getattr(
            pipe.dataset, "label_spec", None)
        for c, iou in enumerate(class_iou):
            if c == self.cfg.train.ignore_cls:
                continue
            name = (class_names.class_names[c]
                    if class_names is not None else str(c))
            self.recorder.scalar(f"{mode}_IOU_{c:02d}_{name}", float(iou),
                                 epoch)
        # qualitative panel: dilated weak | pred | GT | error
        # (trainer.py:874-893 analog)
        if last_panel is not None and class_names is not None:
            from coarse3d_tpu_torch.visualizer import composite_panel

            argmax0, eval0, weak0 = last_panel
            self.recorder.image(
                f"{mode}_Images",
                composite_panel(argmax0, eval0, weak0, class_names),
                epoch)
        self.history.append({
            "epoch": epoch, "mode": mode, "with_contrast": with_contrast,
            "ratio": ratio, "loss": epoch_loss, **results,
            "confusion": self.evaluator.conf.copy(),
            **self.last_epoch_timing})
        log.info(
            f">>> Epoch {epoch + 1} {mode} done: "
            f"loss={epoch_loss.get('total', 0.0):.4f} "
            f"mIoU={results['3DIOU']:.4f} mAcc={results['3DAcc']:.4f}")
        return results

    # ------------------------------------------------------------------
    def fit(self):
        for epoch in range(self.start_epoch, self.cfg.train.n_epochs):
            self.run_epoch(epoch, "Train")
            if self._stop_requested:
                self.ckpt.save_rolling(self.state, epoch)
                self.recorder.logger.warning(
                    f"preemption checkpoint saved at epoch {epoch + 1}; "
                    f"resume with --resume")
                return self.state
            if (epoch % self.cfg.train.val_frequency == 0
                    or epoch == self.cfg.train.n_epochs - 1):
                results = self.run_epoch(epoch, "Validation")
                improved = self.ckpt.save_best(self.state, epoch, {
                    "3DIOU": results["3DIOU"], "3DAcc": results["3DAcc"]})
                if improved:
                    self.recorder.logger.info(
                        f"new best: {improved} at epoch {epoch + 1}")
            self.ckpt.save_rolling(self.state, epoch)
        return self.state
