"""The port's run loop (Trainer, tools/train.py, tools/evaluate.py) on the
CPU, preset ``tiny``.

The cases of tests/test_trainer.py (fit and resume, contrast gating,
``val_use_knn`` routing, best tracking, ``selection_warmup``) run against the
port's Trainer with ``device="cpu"``. Tolerances:

- fit 2 epochs equals fit 1 + resume 1 bit for bit (same device, the
  checkpoint carries the generator);
- against the JAX Trainer from carried weights, dropout 0 and no
  augmentation: a validation epoch's confusion matrix is exact (integer
  counts of an argmax both frameworks agree on, as
  tests/test_torch_train_step.py holds for one step); a two-step warmup
  epoch's mean losses agree within 1e-3 relative (the second step starts
  from each framework's own first update, float32 sums in another order);
- ``tools.evaluate --run_dir`` reproduces the Trainer's last validation
  mIoU exactly (rounded to 4 places, as the tool prints it).
"""

import dataclasses
import json
import logging
import os

import jax
import numpy as np
import pytest
import torch

from coarse3d_tpu.configs import preset as jax_preset
from coarse3d_tpu.data.pipeline import DataPipeline as JaxPipeline
from coarse3d_tpu.data.synthetic import SyntheticDataset as JaxDataset
from coarse3d_tpu.parallel import make_mesh
from coarse3d_tpu.train.trainer import Trainer as JaxTrainer
from coarse3d_tpu.utils import Recorder as JaxRecorder
from coarse3d_tpu_torch.configs import preset
from coarse3d_tpu_torch.data.pipeline import DataPipeline
from coarse3d_tpu_torch.data.synthetic import SyntheticDataset
from coarse3d_tpu_torch.tools import evaluate as evaluate_cli
from coarse3d_tpu_torch.tools import infer as infer_cli
from coarse3d_tpu_torch.tools import train as train_cli
from coarse3d_tpu_torch.tools.convert_jax_params import train_state_from_jax
from coarse3d_tpu_torch.train import step as tstep
from coarse3d_tpu_torch.train.setup import build_state
from coarse3d_tpu_torch.train.trainer import Trainer
from coarse3d_tpu_torch.utils import Recorder


def _cfg(pre, save_path, n_epochs=2, contrast_warmup=99, val_use_knn=False,
         **train_kw):
    cfg = pre("tiny")
    return dataclasses.replace(
        cfg,
        train=dataclasses.replace(cfg.train, n_epochs=n_epochs,
                                  val_frequency=1, val_use_knn=val_use_knn,
                                  **train_kw),
        contrast=dataclasses.replace(cfg.contrast,
                                     contrast_warmup=contrast_warmup),
        save_path=str(save_path))


def _mini_trainer(tmp_path, **kw):
    cfg = _cfg(preset, tmp_path / "run", **kw)
    ds = SyntheticDataset(8, 2000, cfg.data.n_classes, cfg.sensor,
                          weak_ratio=0.01)
    val = SyntheticDataset(2, 2000, cfg.data.n_classes, cfg.sensor,
                           weak_ratio=0.01, seed=9)
    train_pipe = DataPipeline(ds, cfg, batch_size=4, train=True,
                              num_workers=2)
    val_pipe = DataPipeline(val, cfg, batch_size=2, train=False,
                            num_workers=2)
    rec = Recorder(cfg.save_path, settings=cfg, use_tensorboard=False)
    return Trainer(cfg, train_pipe, val_pipe, recorder=rec,
                   device="cpu"), cfg


def _params(trainer):
    return [p.detach().clone() for p in trainer.state.model.parameters()]


def test_fit_two_epochs_and_resume(tmp_path):
    trainer, cfg = _mini_trainer(tmp_path)
    assert trainer.fit() is trainer.state
    assert trainer.state.step == 2 * trainer.steps_per_epoch == 4
    metrics = (tmp_path / "run" / "log" / "metrics.jsonl").read_text()
    assert "Validation_mean_IOU_3D" in metrics and "Train_Loss_total" in metrics
    assert "Train_IOU_01_1" in metrics
    assert [(h["epoch"], h["mode"]) for h in trainer.history] == [
        (0, "Train"), (0, "Validation"), (1, "Train"), (1, "Validation")]
    assert set(trainer.history[0]) >= {"3DIOU", "3DAcc", "3DRecall",
                                       "class_IOU", "loss", "data_s",
                                       "proc_s"}
    assert len(trainer.history[0]["class_IOU"]) == cfg.data.n_classes
    # checkpoints exist; a fresh trainer resumes past both epochs
    trainer2, _ = _mini_trainer(tmp_path)
    assert trainer2.resumed is None
    trainer2.maybe_resume()
    assert trainer2.start_epoch == 2
    assert trainer2.resumed == {
        "epoch": 1, "step": 4,
        "lr": trainer.state.optimizer.param_groups[0]["lr"]}
    for a, b in zip(_params(trainer2), _params(trainer)):
        assert torch.equal(a, b)
    assert trainer2.fit() is trainer2.state and trainer2.state.step == 4
    # nothing to resume in an empty run dir
    trainer3, _ = _mini_trainer(tmp_path / "empty")
    trainer3.maybe_resume()
    assert trainer3.start_epoch == 0


def test_contrast_epoch_gating(tmp_path):
    trainer, cfg = _mini_trainer(tmp_path, n_epochs=1, contrast_warmup=0)
    protos_before = trainer.state.prototypes.clone()
    trainer.run_epoch(0, "Train")
    assert (trainer.state.prototypes - protos_before).abs().sum() > 0
    rec = trainer.history[-1]
    assert rec["with_contrast"] and "contrast" in rec["loss"]
    assert rec["ratio"] == pytest.approx(0.5)     # log2(1 + 1/1) / 2
    # a warmup epoch leaves the memory alone; so does a zero contrast weight
    warm, _ = _mini_trainer(tmp_path / "w", n_epochs=1, contrast_warmup=1)
    before = warm.state.prototypes.clone()
    warm.run_epoch(0, "Train")
    assert torch.equal(warm.state.prototypes, before)
    assert not warm.history[-1]["with_contrast"]
    off, cfg_off = _mini_trainer(tmp_path / "o", n_epochs=1, contrast_warmup=0)
    off.cfg = dataclasses.replace(cfg_off, contrast=dataclasses.replace(
        cfg_off.contrast, loss_w_contrast=0.0))
    off.run_epoch(0, "Train")
    assert not off.history[-1]["with_contrast"]


def test_val_use_knn_routes_into_eval_step(tmp_path, monkeypatch):
    """With train.val_use_knn the training-time validation (which drives
    best-3DIOU selection) runs the KNN-cleaned point predictions."""
    calls = []
    real = tstep.knn_postprocess
    monkeypatch.setattr(tstep, "knn_postprocess",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    trainer, cfg = _mini_trainer(tmp_path, n_epochs=1, val_use_knn=True)
    assert cfg.train.val_use_knn
    results = trainer.run_epoch(0, "Validation")
    assert np.isfinite(results["3DIOU"])
    assert len(calls) == trainer.val_pipe.steps_per_epoch() == 1
    calls.clear()
    trainer2, cfg2 = _mini_trainer(tmp_path / "b", n_epochs=1)
    assert not cfg2.train.val_use_knn
    trainer2.run_epoch(0, "Validation")
    assert not calls


def test_best_checkpoint_tracking(tmp_path):
    trainer, cfg = _mini_trainer(tmp_path, n_epochs=1)
    assert trainer.ckpt.save_best(trainer.state, 0, {"3DIOU": 0.5}) == ["3DIOU"]
    assert trainer.ckpt.save_best(trainer.state, 1, {"3DIOU": 0.4}) == []
    assert trainer.ckpt.save_best(trainer.state, 2, {"3DIOU": 0.6}) == ["3DIOU"]
    fresh = build_state(cfg, device="cpu", seed=9, steps_per_epoch=2)
    restored = trainer.ckpt.restore_best(fresh, key="3DIOU")
    for a, b in zip(restored.model.parameters(),
                    trainer.state.model.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(FileNotFoundError, match="best_nope"):
        trainer.ckpt.restore_best(fresh, key="nope")


def test_selection_warmup_staggers_ratio(tmp_path):
    """contrast.selection_warmup holds the select ratio at 0 until its
    epoch, so the staggered arm trains the memory on clean anchors first."""
    trainer, cfg = _mini_trainer(tmp_path, n_epochs=4, contrast_warmup=1)
    trainer.cfg = dataclasses.replace(
        cfg, contrast=dataclasses.replace(cfg.contrast, selection_warmup=3))
    seen = {}
    real_step = trainer._step_contrast

    def spy(state, batch, ratio):
        seen[epoch] = float(ratio)
        return real_step(state, batch, ratio)

    trainer._step_contrast = spy
    for epoch in range(4):
        trainer.run_epoch(epoch, "Train")
    assert 0 not in seen                     # epoch 0 is a warmup epoch
    assert seen[1] == 0.0 and seen[2] == 0.0
    assert seen[3] == pytest.approx(0.5)     # the schedule takes over
    trainer.recorder.close()


def test_fit_two_equals_fit_one_plus_resume(tmp_path):
    """A run stopped by a signal after its first epoch (the preemption
    checkpoint) and resumed ends bit for bit where the unbroken run ends:
    a contrast epoch with dropout 0.2, so the generator must resume too."""
    whole, _ = _mini_trainer(tmp_path / "a", contrast_warmup=1)
    whole.fit()
    first, _ = _mini_trainer(tmp_path / "b", contrast_warmup=1)
    first._stop_requested = True             # what the signal handler sets
    first.fit()
    assert first.state.step == 2 and first.ckpt.latest_epoch() == 0
    assert [h["mode"] for h in first.history] == ["Train"]
    second, _ = _mini_trainer(tmp_path / "b", contrast_warmup=1)
    second.maybe_resume()
    assert second.start_epoch == 1
    second.fit()
    assert second.state.step == whole.state.step == 4
    for (k, a), b in zip(second.state.model.state_dict().items(),
                         whole.state.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert torch.equal(second.state.prototypes, whole.state.prototypes)
    assert second.history[-1]["3DIOU"] == whole.history[-1]["3DIOU"]
    assert second.history[0]["loss"] == whole.history[2]["loss"]


def test_signal_handler_requests_a_stop(tmp_path):
    import signal

    trainer, _ = _mini_trainer(tmp_path, n_epochs=1)
    old = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        trainer.install_signal_handlers()
        os.kill(os.getpid(), signal.SIGTERM)
        assert trainer._stop_requested
    finally:
        for s, h in old.items():
            signal.signal(s, h)


def test_lovasz_overflow_is_reported(tmp_path, caplog):
    trainer, _ = _mini_trainer(tmp_path, n_epochs=1, lovasz_budget=8)
    with caplog.at_level(logging.ERROR, logger="coarse3d_tpu_torch"):
        trainer.run_epoch(0, "Train")
    assert "LOVASZ BUDGET OVERFLOW" in caplog.text
    assert trainer.history[-1]["loss"]["lovasz_overflow"] > 0


def test_profile_window_writes_a_trace(tmp_path):
    trainer, cfg = _mini_trainer(tmp_path, n_epochs=1)
    trainer.profile_steps = (0, 1)
    trainer.run_epoch(0, "Train")
    assert os.path.getsize(tmp_path / "run" / "profile" / "trace.json") > 0
    assert trainer.last_profile_syncs == {}      # no card, no CUDA calls


@pytest.fixture(scope="module")
def against_jax(tmp_path_factory):
    """Both Trainers on the same catalogs, dropout 0, no augmentation, the
    port carrying the JAX Trainer's initial state."""
    tmp = tmp_path_factory.mktemp("jax")

    def plain(cfg):
        aug = dataclasses.replace(cfg.augment, **{
            f.name: 0.0 for f in dataclasses.fields(cfg.augment)
            if f.name.startswith("p_")})
        return dataclasses.replace(
            cfg, augment=aug,
            model=dataclasses.replace(cfg.model, dropout_rate=0.0))

    cfg_j = plain(_cfg(jax_preset, tmp / "j", n_epochs=1, val_use_knn=True))
    cfg_t = plain(_cfg(preset, tmp / "t", n_epochs=1, val_use_knn=True))
    assert dataclasses.asdict(cfg_j) == dict(dataclasses.asdict(cfg_t),
                                             save_path=cfg_j.save_path)
    pipes = {}
    for name, ds_cls, pipe_cls, cfg, kw in (
            ("j", JaxDataset, JaxPipeline, cfg_j,
             dict(process_index=0, process_count=1)),
            ("t", SyntheticDataset, DataPipeline, cfg_t, {})):
        ds = ds_cls(4, 2000, cfg.data.n_classes, cfg.sensor, weak_ratio=0.01)
        val = ds_cls(3, 2000, cfg.data.n_classes, cfg.sensor,
                     weak_ratio=0.01, seed=9)
        pipes[name] = (pipe_cls(ds, cfg, 2, train=True, num_workers=2, **kw),
                       pipe_cls(val, cfg, 2, train=False, num_workers=2, **kw))
    jt = JaxTrainer(cfg_j, *pipes["j"], recorder=JaxRecorder(
        cfg_j.save_path, settings=cfg_j, use_tensorboard=False),
        mesh=make_mesh(1))
    tt = Trainer(cfg_t, *pipes["t"], device="cpu")
    tt.state.load(train_state_from_jax(jax.device_get(jt.state)))
    return jt, tt, cfg_j


def test_validation_epoch_matches_jax(against_jax):
    jt, tt, _ = against_jax
    want = jt.run_epoch(0, "Validation")
    got = tt.run_epoch(0, "Validation")
    np.testing.assert_array_equal(tt.evaluator.conf, jt.evaluator.conf)
    assert tt.evaluator.conf.sum() == 3 * 2000     # the padded tail adds none
    for k in ("3DIOU", "3DAcc", "3DRecall"):
        assert got[k] == pytest.approx(want[k], rel=1e-6)
    assert got["class_IOU"] == want["class_IOU"]


def test_warmup_epoch_losses_match_jax(against_jax):
    jt, tt, cfg_j = against_jax
    jt.run_epoch(0, "Train")
    tt.run_epoch(0, "Train")
    jt.recorder.writer._jsonl.flush()
    with open(os.path.join(cfg_j.save_path, "log", "metrics.jsonl")) as f:
        rows = [json.loads(ln) for ln in f]
    want = {r["tag"].removeprefix("Train_Loss_"): r["value"] for r in rows
            if r["tag"].startswith("Train_Loss_")}
    got = tt.history[-1]["loss"]
    assert tt.history[-1]["steps"] == 2 and set(want) == {"total", "focal",
                                                          "lovasz"}
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-3), k
    assert int(jt.state.step) == tt.state.step == 2


# -- the CLIs --------------------------------------------------------------------

_CLI = ["--preset", "tiny", "--synthetic_points", "2000", "--device", "cpu",
        "--num_workers", "2"]


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    run_dir = str(tmp_path_factory.mktemp("cli") / "run")
    trainer = train_cli.main(_CLI + [
        "--synthetic", "8", "--epochs", "1", "--batch_size", "2",
        "--save_path", run_dir, "--set", "contrast.contrast_warmup=0",
        "--set", "train.val_use_knn=true", "--profile_steps", "1", "2"])
    return run_dir, trainer


def test_train_cli_one_epoch(cli_run):
    run_dir, trainer = cli_run
    assert trainer.state.step == 4 and trainer.device.type == "cpu"
    assert [h["mode"] for h in trainer.history] == ["Train", "Validation"]
    assert trainer.history[0]["with_contrast"]
    assert sorted(os.listdir(os.path.join(run_dir, "checkpoint"))) == [
        "best_3DAcc.pth", "best_3DIOU.pth", "epoch_0000.pth"]
    for sub in ("log/console.log", "log/metrics.jsonl", "settings.json",
                "code/coarse3d_tpu_torch/tools/train.py",
                "profile/trace.json"):
        assert os.path.exists(os.path.join(run_dir, sub)), sub


@pytest.mark.parametrize("ckpt", ["latest", "best_3DIOU"])
def test_evaluate_cli_reads_the_run_dir(cli_run, tmp_path, ckpt):
    run_dir, trainer = cli_run
    last = trainer.history[-1]
    summary = tmp_path / "s" / "summary.json"
    out = evaluate_cli.main(_CLI + [
        "--synthetic", "2", "--synthetic_seed",
        str(trainer.cfg.train.seed + 1), "--batch_size", "2", "--run_dir",
        run_dir, "--ckpt", ckpt, "--knn", "--summary_json", str(summary),
        "--save_preds", str(tmp_path / "preds")])
    assert out["mIoU_3D"] == round(last["3DIOU"], 4)
    assert out["mAcc_3D"] == round(last["3DAcc"], 4)
    assert [round(v, 4) for v in out["class_iou"]] == last["class_IOU"]
    np.testing.assert_array_equal(out["confusion"], last["confusion"])
    assert int(np.sum(out["confusion"])) > 0
    assert out["knn"] and not out["crf"] and out["scans"] == 2
    assert json.loads(summary.read_text()) == out
    preds = sorted(os.listdir(tmp_path / "preds"))
    assert preds == ["synth_000000.label", "synth_000001.label"]
    assert np.fromfile(tmp_path / "preds" / preds[0], np.int32).shape == (2000,)


def test_evaluate_and_infer_cli_take_weights_or_run_dir(cli_run, tmp_path):
    run_dir, trainer = cli_run
    weights = tmp_path / "model.pth"
    torch.save(trainer.state.model.state_dict(), weights)
    a = evaluate_cli.main(_CLI + ["--synthetic", "2", "--batch_size", "2",
                                  "--weights", str(weights)])
    b = evaluate_cli.main(_CLI + ["--synthetic", "2", "--batch_size", "2",
                                  "--run_dir", run_dir])
    assert a == b and not a["knn"]
    scan = tmp_path / "000000.bin"
    SyntheticDataset(1, 1500, 8, trainer.cfg.sensor).load(0)["points"].tofile(
        scan)
    outs = []
    for name, src in (("w", ["--weights", str(weights)]),
                      ("r", ["--run_dir", run_dir, "--ckpt", "3DIOU"])):
        infer_cli.main(["--preset", "tiny", "--device", "cpu", "--scans",
                        str(scan), "--out", str(tmp_path / name)] + src)
        outs.append(np.fromfile(tmp_path / name / "000000.label", np.int32))
    assert outs[0].shape == (1500,)
    np.testing.assert_array_equal(outs[0], outs[1])


def test_train_cli_pretrained_and_val_only(cli_run, tmp_path, capsys):
    run_dir, trainer = cli_run
    weights = tmp_path / "model.pth"
    torch.save({"model": trainer.state.model.state_dict()}, weights)
    results = train_cli.main(_CLI + [
        "--synthetic", "8", "--batch_size", "2", "--save_path",
        str(tmp_path / "run"), "--set", "train.val_use_knn=true",
        "--pretrained", str(weights), "--val_only"])
    # all weights carried: the same validation as the run that trained them
    assert results["3DIOU"] == trainer.history[-1]["3DIOU"]
    assert "pretrained tensors" in capsys.readouterr().out
    enc = train_cli.main(_CLI + [
        "--synthetic", "8", "--batch_size", "2", "--save_path",
        str(tmp_path / "run2"), "--pretrained", str(weights),
        "--only_encoder", "--val_only"])
    assert "(encoder only)" in capsys.readouterr().out
    assert np.isfinite(enc["3DIOU"])


@pytest.mark.parametrize("argv, error", [
    (["--multihost"], NotImplementedError),
    (["--stem", "s2d"], NotImplementedError),
    (["--stem", "s2d_w"], NotImplementedError),
    (["--pretrained", "x.pth", "--resume"], SystemExit),
])
def test_train_cli_refuses(argv, error):
    with pytest.raises(error):
        train_cli.main(_CLI + ["--synthetic", "4"] + argv)


@pytest.mark.parametrize("argv, error", [
    (["--crf", "--run_dir", "x"], NotImplementedError),
    (["--crf", "--crf_kernel", "k.npz"], NotImplementedError),
    (["--crf_kernel", "k.npz"], SystemExit),
    (["--weights", "w.pth", "--run_dir", "x"], SystemExit),
    (["--weights", "w.pth", "--ckpt", "best_3DIOU"], SystemExit),
])
def test_evaluate_cli_refuses(argv, error):
    with pytest.raises(error):
        evaluate_cli.main(_CLI + ["--synthetic", "2"] + argv)


@pytest.mark.parametrize("entry", ["trainer", "train_cli", "evaluate_cli"])
def test_run_loop_entry_points_default_to_cuda(entry, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--preset", "tiny", "--synthetic", "4", "--save_path",
            str(tmp_path)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "trainer":
            cfg = _cfg(preset, tmp_path)
            ds = SyntheticDataset(4, 500, 8, cfg.sensor)
            Trainer(cfg, DataPipeline(ds, cfg, 2),
                    DataPipeline(ds, cfg, 2, train=False))
        elif entry == "train_cli":
            train_cli.main(argv)
        else:
            evaluate_cli.main(argv[:4])
