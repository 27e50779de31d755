"""The port's data path (readers, augmentation, synthetic catalogs, dataset
catalogs, native host preprocessing, ``build_sample``, ``DataPipeline``)
and its small host utilities (meters, recorder, visualizer, submission
writer, top-k accuracy) against the JAX package, on the CPU.

Tolerances: everything here is host numpy, copied, so the same inputs and
seeds give exactly equal outputs, with two exceptions stated where they
apply: native against numpy projection as ``tests/test_native.py`` holds it
(depth rtol 1e-6, winners agree on > 0.99 of pixels), and recorder
timestamps, which are dropped before comparing.
"""

import dataclasses
import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coarse3d_tpu import native as jnative
from coarse3d_tpu.configs import preset as jax_preset
from coarse3d_tpu.data import augment as jaug
from coarse3d_tpu.data import datasets as jds
from coarse3d_tpu.data import pipeline as jpipe
from coarse3d_tpu.data import readers as jrd
from coarse3d_tpu.data import synthetic as jsyn
from coarse3d_tpu.eval import submission as jsub
from coarse3d_tpu.metrics import acc_eval as jacc
from coarse3d_tpu.utils import meters as jmeters
from coarse3d_tpu.utils import recorder as jrec
from coarse3d_tpu.visualizer import vis as jvis
from coarse3d_tpu_torch import native as tnative
from coarse3d_tpu_torch.configs import preset
from coarse3d_tpu_torch.data import augment as taug
from coarse3d_tpu_torch.data import datasets as tds
from coarse3d_tpu_torch.data import pipeline as tpipe
from coarse3d_tpu_torch.data import readers as trd
from coarse3d_tpu_torch.data import synthetic as tsyn
from coarse3d_tpu_torch.eval import submission as tsub
from coarse3d_tpu_torch.metrics import acc_eval as tacc
from coarse3d_tpu_torch.ops import projection as tproj
from coarse3d_tpu_torch.utils import meters as tmeters
from coarse3d_tpu_torch.utils import recorder as trec
from coarse3d_tpu_torch.visualizer import vis as tvis


def _equal_dicts(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- readers, augmentation, synthetic catalogs ---------------------------------

def test_readers_match(tmp_path):
    rng = np.random.default_rng(0)
    files = {
        "scan.bin": rng.normal(size=40).astype(np.float32),
        "label.label": rng.integers(0, 2**24, 30).astype(np.int32),
        "tag.tag": rng.random(50) < 0.5,
        "seg.bin": rng.integers(0, 32, 30).astype(np.uint8),
    }
    for name, arr in files.items():
        arr.tofile(tmp_path / name)
    np.save(tmp_path / "weak.npy", rng.integers(0, 20, (30, 1)))
    for fn, name in (("read_kitti_scan", "scan.bin"),
                     ("read_nuscenes_scan", "scan.bin"),
                     ("read_weak_label", "weak.npy"),
                     ("read_poss_tag", "tag.tag"),
                     ("read_nuscenes_label", "seg.bin")):
        got = getattr(trd, fn)(str(tmp_path / name))
        want = getattr(jrd, fn)(str(tmp_path / name))
        assert got.dtype == want.dtype and got.shape == want.shape, fn
        np.testing.assert_array_equal(got, want, err_msg=fn)
    for got, want in zip(trd.read_kitti_label(str(tmp_path / "label.label")),
                         jrd.read_kitti_label(str(tmp_path / "label.label"))):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_augment_matches(seed):
    cfg_t, cfg_j = preset("kitti").augment, jax_preset("kitti").augment
    pts = np.random.default_rng(seed).normal(size=(500, 4)).astype(np.float32)
    got = taug.augment_pointcloud(pts, cfg_t, np.random.default_rng(seed))
    want = jaug.augment_pointcloud(pts, cfg_j, np.random.default_rng(seed))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, pts)
    np.testing.assert_array_equal(taug._euler_zyx_matrix(10., -20., 30.),
                                  jaug._euler_zyx_matrix(10., -20., 30.))


@pytest.mark.parametrize("kind", ["bands", "hard", "hard_imbalanced"])
def test_synthetic_catalogs_match(kind):
    sensor = preset("tiny").sensor
    if kind == "bands":
        args, kw = (3, 1500, 8, sensor), dict(weak_ratio=0.01, seed=4)
        got, want = tsyn.SyntheticDataset(*args, **kw), jsyn.SyntheticDataset(
            *args, **kw)
    else:
        kw = dict(seed=5, noise=0.1, weak_label_noise=0.2)
        if kind == "hard_imbalanced":
            kw.update(imbalance=4.0, n_segments=9)
        args = (3, 1500, 8, sensor)
        got = tsyn.SyntheticHardDataset(*args, **kw)
        want = jsyn.SyntheticHardDataset(*args, **kw)
    assert len(got) == len(want) and got.name == want.name
    assert got.path_info(2) == want.path_info(2)
    for i in range(3):
        _equal_dicts(got.load(i), want.load(i))
    first = got.load(1)
    first["points"][:] = 0          # the cache serves copies
    assert got.load(1)["points"].any()


def test_texture_periods_and_hard_task_kwargs_match():
    for args in ((8, 10.0), (20, 341.3, 3), (5, 4.0, 2, 2.0)):
        np.testing.assert_array_equal(tsyn.texture_periods(*args),
                                      jsyn.texture_periods(*args))
    import argparse

    ns = argparse.Namespace(synthetic_segments=7, synthetic_modes=None,
                            synthetic_noise=0.3, synthetic_imbalance=2.0)
    assert tsyn.hard_task_kwargs(ns) == jsyn.hard_task_kwargs(ns) == {
        "n_segments": 7, "noise": 0.3, "imbalance": 2.0}
    with pytest.raises(ValueError):
        tsyn.synthetic_hard_scan(np.random.default_rng(0), 100, 8,
                                 preset("tiny").sensor, n_segments=3,
                                 imbalance=4.0)


# -- dataset catalogs ------------------------------------------------------------

def _write_kitti_tree(root, seqs, rng, n_scans=2, poss=False, h=8, w=32):
    raw_ids = [0, 10, 40, 50, 70] if not poss else [0, 4, 6, 9, 15]
    for seq in seqs:
        for sub in ("velodyne", "labels", "tag"):
            os.makedirs(root / f"{seq:02d}" / sub, exist_ok=True)
        os.makedirs(root / "weak" / f"{seq:02d}" / "0.1", exist_ok=True)
        for i in range(n_scans):
            n = 40 + 3 * i
            rng.normal(0, 10, (n, 4)).astype(np.float32).tofile(
                root / f"{seq:02d}" / "velodyne" / f"{i:06d}.bin")
            sem = rng.choice(raw_ids, n).astype(np.int32)
            (sem | (rng.integers(0, 9, n).astype(np.int32) << 16)).tofile(
                root / f"{seq:02d}" / "labels" / f"{i:06d}.label")
            np.save(root / "weak" / f"{seq:02d}" / "0.1" / f"{i:06d}.npy",
                    np.where(rng.random(n) < 0.3, sem, 0))
            tag = np.zeros(h * w, bool)
            tag[rng.choice(h * w, n, replace=False)] = True
            tag.tofile(root / f"{seq:02d}" / "tag" / f"{i:06d}.tag")


@pytest.mark.parametrize("dataset", ["semantic_kitti", "semantic_poss"])
def test_sequence_catalogs_match(tmp_path, dataset):
    _write_kitti_tree(tmp_path, (0, 3), np.random.default_rng(1),
                      poss=dataset == "semantic_poss")
    pair = []
    for mod, pre in ((tds, preset), (jds, jax_preset)):
        cfg = pre("kitti" if dataset == "semantic_kitti" else "poss")
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, pcd_root=str(tmp_path), weak_root=str(tmp_path / "weak"),
            weak_label_name="0.1", train_seq=(0, 3), val_seq=(3,)))
        pair.append((mod.build_dataset(cfg, "train"),
                     mod.build_dataset(cfg, "val")))
    (got, got_val), (want, want_val) = pair
    assert type(got).__name__ == type(want).__name__
    assert len(got) == len(want) == 4 and len(got_val) == len(want_val) == 2
    assert not got_val.has_weak
    for i in range(4):
        assert got.path_info(i) == want.path_info(i)
        _equal_dicts(got.load(i), want.load(i))
    _equal_dicts(got_val.load(1), want_val.load(1))
    assert ("tags" in got.load(0)) == (dataset == "semantic_poss")
    with pytest.raises(FileNotFoundError):
        tds.SemanticKittiDataset(str(tmp_path), (7,))


def test_nuscenes_catalog_matches(tmp_path):
    rng = np.random.default_rng(2)
    records = []
    for i in range(3):
        n = 50
        pts = rng.normal(0, 3, (n, 5)).astype(np.float32)
        pts[:5, :3] *= 0.01                      # inside the 1 m filter
        pts.tofile(tmp_path / f"{i}.pcd.bin")
        rng.integers(0, 32, n).astype(np.uint8).tofile(tmp_path / f"{i}.seg")
        np.save(tmp_path / f"{i}.npy", rng.integers(0, 17, n))
        records.append({"lidar": f"{i}.pcd.bin", "lidarseg": f"{i}.seg",
                        "weak": f"{i}.npy" if i else None, "token": f"t{i}"})
    for split in ("train", "val"):
        with open(tmp_path / f"manifest_{split}.jsonl", "w") as f:
            f.write("\n".join(json.dumps(r) for r in records) + "\n")
    pair = []
    for mod, pre in ((tds, preset), (jds, jax_preset)):
        cfg = pre("nuscenes")
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, pcd_root=str(tmp_path)))
        pair.append(mod.build_dataset(cfg, "val"))
    got, want = pair
    assert len(got) == len(want) == 3
    for i in range(3):
        assert got.path_info(i) == want.path_info(i) == ("nusc", f"t{i}")
        _equal_dicts(got.load(i), want.load(i))
    assert len(got.load(0)["points"]) < 50
    with pytest.raises(ValueError, match="unknown dataset"):
        tds.build_dataset(dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, dataset="nope")))


# -- native host preprocessing -----------------------------------------------------

def _need_native():
    if not (tnative.available() and jnative.available()):
        pytest.skip("no g++ / native build failed")


def test_native_source_is_a_copy_and_builds_into_build_dir():
    """preprocess.cpp differs from the original in comments only; the
    library lands in the package's build/ directory, not beside the
    source."""
    def code(path):
        with open(path) as f:
            return [ln.split("//")[0].rstrip() for ln in f
                    if ln.split("//")[0].strip()]

    t_dir = os.path.dirname(tnative.__file__)
    j_dir = os.path.dirname(jnative.__file__)
    assert code(os.path.join(t_dir, "preprocess.cpp")) == code(
        os.path.join(j_dir, "preprocess.cpp"))
    _need_native()
    assert not [f for f in os.listdir(t_dir) if f.endswith(".so")]
    build = os.path.join(os.path.dirname(t_dir), "build")
    assert [f for f in os.listdir(build) if re.match(r"_preprocess_\w+\.so", f)]


@pytest.mark.parametrize("case", ["plain", "keep_point0", "override"])
def test_native_bindings_match_original(case):
    _need_native()
    sensor = preset("tiny").sensor
    scan = tsyn.synthetic_scan(np.random.default_rng(6), 3000, 8, sensor, 0.01)
    kw = {}
    if case == "keep_point0":
        kw["mask_excludes_point0"] = False
    if case == "override":
        kw["depth_override"] = np.where(scan["weak_labels"] > 0, 1.0, 1e4)
    got = tnative.range_project_native(scan["points"], sensor, **kw)
    want = jnative.range_project_native(scan["points"], sensor, **kw)
    _equal_dicts(got, want)
    np.testing.assert_array_equal(
        tnative.scatter_labels_native(got["proj_idx"], scan["labels"]),
        jnative.scatter_labels_native(want["proj_idx"], scan["labels"]))
    xyz = np.random.default_rng(7).uniform(0, 30, (4000, 3)).astype(np.float32)
    for a, b in zip(tnative.voxelize_native(xyz, 0.5),
                    jnative.voxelize_native(xyz, 0.5)):
        np.testing.assert_array_equal(a, b)


def test_native_matches_numpy_projection():
    """As tests/test_native.py holds the original: px / py exact, depth
    rtol 1e-6, winners agree on > 0.99 of pixels (float32 against double
    norm near ties) and nearly tie where they differ; label scatter exact."""
    _need_native()
    sensor = preset("tiny").sensor
    scan = tsyn.synthetic_scan(np.random.default_rng(8), 8000, 8, sensor)
    want = tproj.range_project_np(scan["points"], sensor)
    got = tnative.range_project_native(scan["points"], sensor)
    np.testing.assert_array_equal(got["px"], want["px"])
    np.testing.assert_array_equal(got["py"], want["py"])
    np.testing.assert_allclose(got["depth"], want["depth"], rtol=1e-6)
    agree = got["proj_idx"] == want["proj_idx"]
    assert agree.mean() > 0.99, agree.mean()
    np.testing.assert_allclose(got["proj_range"][~agree],
                               want["proj_range"][~agree], atol=1e-3)
    np.testing.assert_array_equal(
        tnative.scatter_labels_native(got["proj_idx"], scan["labels"]),
        tproj.scatter_labels_np(got["proj_idx"], scan["labels"]))


def test_native_gate(monkeypatch):
    """COARSE3D_NATIVE=0 switches the library off; build_sample then takes
    the numpy path and still equals the original's."""
    for mod in (tnative, jnative):
        monkeypatch.setattr(mod, "_TRIED", False)
        monkeypatch.setattr(mod, "_LIB", None)
    monkeypatch.setenv("COARSE3D_NATIVE", "0")
    assert not tnative.available() and not jnative.available()
    sensor = preset("tiny").sensor
    scan = tsyn.synthetic_scan(np.random.default_rng(9), 2000, 8, sensor, 0.01)
    _equal_dicts(tpipe.build_sample(scan, sensor, 4096, train=False),
                 jpipe.build_sample(scan, sensor, 4096, train=False))


# -- build_sample and the pipeline ---------------------------------------------------

def test_numpy_features_match():
    rng = np.random.default_rng(10)
    pp = rng.normal(size=(6, 7, 4)).astype(np.float32)
    pp[rng.random((6, 7)) < 0.3] = -1.0
    pr = rng.uniform(-1, 50, (6, 7)).astype(np.float32)
    got = tproj.build_range_features_np(pp, pr)
    from coarse3d_tpu.ops import projection as jproj

    np.testing.assert_array_equal(got, jproj.build_range_features(pp, pr,
                                                                  xp=np))
    np.testing.assert_array_equal(got, tproj.build_range_features(
        torch.from_numpy(pp), torch.from_numpy(pr)).numpy())


@pytest.mark.parametrize("train", [True, False])
def test_build_sample_kitti_path_matches(train):
    cfg_t, cfg_j = preset("tiny"), jax_preset("tiny")
    scan = tsyn.synthetic_scan(np.random.default_rng(11), 3000, 8,
                               cfg_t.sensor, weak_ratio=0.01)
    got = tpipe.build_sample(scan, cfg_t.sensor, 4096, augment=cfg_t.augment,
                             rng=np.random.default_rng(5), train=train)
    want = jpipe.build_sample(scan, cfg_j.sensor, 4096, augment=cfg_j.augment,
                              rng=np.random.default_rng(5), train=train)
    _equal_dicts(got, want)
    assert set(got) == set(tpipe.BATCH_KEYS) == set(jpipe.BATCH_KEYS)
    assert (got["train_label"] > 0).any()


def test_build_sample_weak_fallback_matches():
    """Every weak point hidden behind a nearer point: the sample is
    re-projected with the weak points forced nearest."""
    sensor = preset("tiny").sensor
    scan = tsyn.synthetic_scan(np.random.default_rng(12), 1500, 8, sensor,
                               weak_ratio=0.002)
    weak_idx = np.flatnonzero(scan["weak_labels"])
    assert len(weak_idx) >= 2
    blockers = scan["points"][weak_idx].copy()
    blockers[:, :3] *= 0.5                      # same pixel, half the range
    scan = {"points": np.concatenate([scan["points"], blockers]),
            "labels": np.concatenate([scan["labels"],
                                      scan["labels"][weak_idx]]),
            "weak_labels": np.concatenate([scan["weak_labels"],
                                           np.zeros(len(weak_idx), np.int32)])}
    eval_like = tpipe.build_sample(scan, sensor, 4096, train=False)
    assert (eval_like["train_label"] > 0).sum() == 0    # occluded
    got = tpipe.build_sample(scan, sensor, 4096, train=True)
    want = jpipe.build_sample(scan, sensor, 4096, train=True)
    _equal_dicts(got, want)
    assert (got["train_label"] > 0).sum() > 0           # the fallback ran


def test_build_sample_poss_tag_path_matches():
    sensor = preset("poss").sensor
    rng = np.random.default_rng(13)
    n = 5000
    tags = np.zeros(sensor.proj_h * sensor.proj_w, bool)
    tags[rng.choice(tags.size, n, replace=False)] = True
    scan = {"points": rng.normal(0, 20, (n, 4)).astype(np.float32),
            "labels": rng.integers(0, 14, n).astype(np.int32),
            "weak_labels": rng.integers(0, 14, n).astype(np.int32) * (
                rng.random(n) < 0.01),
            "tags": tags}
    scan["weak_labels"] = scan["weak_labels"].astype(np.int32)
    got = tpipe.build_sample(scan, sensor, 8192, train=True)
    want = jpipe.build_sample(scan, jax_preset("poss").sensor, 8192,
                              train=True)
    _equal_dicts(got, want)
    flat = np.flatnonzero(tags)
    np.testing.assert_array_equal(got["point_px"][:n], flat % sensor.proj_w)
    for a, b in zip(tpipe._tag_pixels(tags, sensor.proj_w),
                    jpipe._tag_pixels(tags, sensor.proj_w)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("train", [True, False])
def test_pipeline_epoch_matches(train):
    """The same batches in the same order: shuffled with drop_last in
    training, in catalog order with a padded tail in evaluation."""
    cfg_t, cfg_j = preset("tiny"), jax_preset("tiny")
    args = (7, 1500, 8)
    got_pipe = tpipe.DataPipeline(
        tsyn.SyntheticDataset(*args, cfg_t.sensor, seed=3), cfg_t, 3,
        train=train, seed=5, num_workers=2)
    want_pipe = jpipe.DataPipeline(
        jsyn.SyntheticDataset(*args, cfg_j.sensor, seed=3), cfg_j, 3,
        train=train, seed=5, num_workers=2, process_index=0, process_count=1)
    assert got_pipe.steps_per_epoch() == want_pipe.steps_per_epoch() == (
        2 if train else 3)
    for epoch in (0, 1):
        got, want = list(got_pipe.epoch(epoch)), list(want_pipe.epoch(epoch))
        assert len(got) == len(want) == got_pipe.steps_per_epoch()
        for g, w in zip(got, want):
            _equal_dicts(g, w)
            assert g["features"].shape[0] == 3
    if train:
        assert not np.array_equal(got[0]["scan_index"],
                                  list(got_pipe.epoch(0))[0]["scan_index"])
    else:
        tail = got[-1]
        np.testing.assert_array_equal(tail["scan_index"], [6, -1, -1])
        assert not tail["point_valid"][1:].any()
        assert not tail["eval_label"][1:].any()
    # striping: two processes split the catalog
    halves = [tpipe.DataPipeline(got_pipe.dataset, cfg_t, 1, train=False,
                                 process_index=i, process_count=2)
              for i in (0, 1)]
    assert [len(h._epoch_indices(0)) for h in halves] == [4, 3]


def test_pipeline_worker_error_reaches_the_consumer():
    cfg = preset("tiny")

    class Broken(tsyn.SyntheticDataset):
        def load(self, index):
            if index == 2:
                raise OSError("scan 2 is unreadable")
            return super().load(index)

    pipe = tpipe.DataPipeline(Broken(4, 500, 8, cfg.sensor), cfg, 2,
                              train=False, num_workers=2)
    seen = []
    with pytest.raises(OSError, match="scan 2 is unreadable"):
        for batch in pipe.epoch(0):
            seen.append(batch["scan_index"].tolist())
    assert seen == [[0, 1]]


def test_pad_tail_batch_matches():
    rng = np.random.default_rng(14)
    batch = {"features": rng.normal(size=(2, 4, 4, 5)).astype(np.float32),
             "point_valid": np.ones((2, 6), bool),
             "eval_label": rng.integers(1, 5, (2, 4, 4)).astype(np.int32),
             "point_px": rng.integers(0, 4, (2, 6)).astype(np.int32),
             "scan_index": np.array([4, 5], np.int32)}
    _equal_dicts(tpipe._pad_tail_batch(batch, 5),
                 jpipe._pad_tail_batch(batch, 5))


# -- meters, recorder, visualizer, submission, accuracy -------------------------------

def test_meters_match():
    for tm, jm in ((tmeters.AverageMeter(), jmeters.AverageMeter()),
                   (tmeters.RunningAvgMeter(0.9), jmeters.RunningAvgMeter(0.9))):
        for i, v in enumerate((3.0, 1.5, 8.25)):
            if isinstance(tm, tmeters.AverageMeter):
                tm.update(v, i + 1), jm.update(v, i + 1)
            else:
                tm.update(v), jm.update(v)
            assert tm.avg == jm.avg
    tr, jr = tmeters.RemainTime(5), jmeters.RemainTime(5)
    for r in (tr, jr):
        r.update(0.5, "Train"), r.update(0.7, "Train")
        r.update(0.2, "Validation")
    assert tr.get_remain_time(1, 3, 10, "Train") == jr.get_remain_time(
        1, 3, 10, "Train") > 0
    assert tr.get_remain_time(1, 0, 4, "Validation") == jr.get_remain_time(
        1, 0, 4, "Validation")


def test_recorder_matches(tmp_path):
    cfg = preset("tiny")
    src = tmp_path / "src"
    os.makedirs(src / "pkg" / "__pycache__")
    (src / "pkg" / "a.py").write_text("x = 1\n")
    (src / "pkg" / "b.txt").write_text("skip\n")
    (src / "pkg" / "__pycache__" / "c.py").write_text("skip\n")
    trees = []
    for mod, name in ((trec, "t"), (jrec, "j")):
        rec = mod.Recorder(str(tmp_path / name), settings=cfg,
                           snapshot_code_root=str(src), use_tensorboard=False)
        rec.scalar("Train_Loss_total", 1.25, 0)
        rec.scalar("Validation_mean_IOU_3D", 0.5, 3)
        rec.image("x", np.zeros((2, 2, 3)), 0)
        rec.logger.info("hello")
        rec.close()
        assert not rec.logger.handlers
        root = tmp_path / name
        files = sorted(os.path.relpath(os.path.join(d, f), root)
                       for d, _, fs in os.walk(root) for f in fs)
        with open(root / "log" / "metrics.jsonl") as f:
            rows = [{k: v for k, v in json.loads(ln).items() if k != "ts"}
                    for ln in f]
        with open(root / "settings.json") as f:
            settings = json.load(f)
        trees.append((files, rows, settings))
    assert trees[0] == trees[1]
    assert "code/pkg/a.py" in trees[0][0] and len(trees[0][1]) == 2
    off = trec.Recorder(str(tmp_path / "off"), enabled=False)
    off.scalar("a", 1.0, 0)
    assert not os.path.exists(tmp_path / "off")
    off.close()


def test_visualizer_matches(tmp_path):
    from coarse3d_tpu.data.label_maps import get_label_spec as jspec
    from coarse3d_tpu_torch.data.label_maps import get_label_spec as tspec

    rng = np.random.default_rng(15)
    argmax = rng.integers(0, 20, (16, 64))
    full = rng.integers(0, 20, (16, 64))
    weak = full * (rng.random((16, 64)) < 0.02)
    got = tvis.composite_panel(argmax, full, weak, tspec("semantic_kitti"))
    want = jvis.composite_panel(argmax, full, weak, jspec("semantic_kitti"))
    assert got.shape == (64, 64, 3)
    np.testing.assert_array_equal(got, want)
    img = rng.uniform(-1, 30, (8, 8))
    np.testing.assert_array_equal(tvis.normalize_range_image(img),
                                  jvis.normalize_range_image(img))
    rgb = rng.random((8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(tvis.dilate_rgb(rgb, 3), jvis.dilate_rgb(rgb, 3))
    xyz = rng.normal(size=(10, 3))
    for binary in (True, False):
        tvis.save_ply(str(tmp_path / "t.ply"), xyz, rng.random((10, 3)) * 0 + .5,
                      binary=binary)
        jvis.save_ply(str(tmp_path / "j.ply"), xyz, rng.random((10, 3)) * 0 + .5,
                      binary=binary)
        assert (tmp_path / "t.ply").read_bytes() == (
            tmp_path / "j.ply").read_bytes()


@pytest.mark.parametrize("dataset", ["semantic_kitti", "nuscenes", "synthetic"])
def test_submission_writer_matches(tmp_path, dataset):
    from coarse3d_tpu.data.label_maps import get_label_spec as jspec
    from coarse3d_tpu_torch.data.label_maps import get_label_spec as tspec

    pred = np.random.default_rng(16).integers(0, 17, 200).astype(np.int32)
    out = []
    for mod, spec, name in ((tsub, tspec, "t"), (jsub, jspec, "j")):
        label_spec = spec(dataset) if dataset != "synthetic" else None
        w = mod.SubmissionWriter(str(tmp_path / name), dataset, label_spec)
        path = w.write("08", "000003", pred)
        w.finalize()
        back = mod.read_submission(str(tmp_path / name), dataset, "08",
                                   "000003", label_spec)
        with open(path, "rb") as f:
            out.append((os.path.relpath(path, tmp_path / name), f.read(),
                        back, w.count))
    assert out[0][0] == out[1][0] and out[0][1] == out[1][1]
    np.testing.assert_array_equal(out[0][2], out[1][2])
    if dataset == "synthetic":
        np.testing.assert_array_equal(out[0][2], pred)
    else:
        np.testing.assert_array_equal(out[0][2], np.maximum(pred, 1))


def test_topk_accuracy_matches():
    """The same hit counts as the JAX function on continuous logits (no
    ties); the float32 means of 300 hits may differ in the last bit."""
    rng = np.random.default_rng(17)
    logits = rng.normal(size=(300, 10)).astype(np.float32)
    target = rng.integers(0, 10, 300)
    got = tacc.topk_accuracy(torch.from_numpy(logits),
                             torch.from_numpy(target), (1, 3, 5))
    want = jacc.topk_accuracy(jnp.asarray(logits), jnp.asarray(target),
                              (1, 3, 5))
    for g, w in zip(got, want):
        assert round(float(g) * 300) == round(float(w) * 300)
        assert abs(float(g) - float(w)) < 1e-6
    assert float(got[0]) < float(got[1]) < float(got[2])
    tm, jm = tacc.ClassifierAverageMeter(), jacc.ClassifierAverageMeter()
    for m in (tm, jm):
        m.update({"a": 1.0, "b": 3.0}, 2)
        m.update({"a": 4.0}, 1)
    assert tm.averages() == jm.averages() == {"a": 2.0, "b": 3.0}
