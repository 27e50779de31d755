"""The port's tools (coarse3d_tpu_torch/tools: contrast_ablation,
gen_weak_labels, build_nuscenes_manifest, baseline_matrix, visualize,
convert_torch_ckpt, export_torch_ckpt, and infer's --submission path)
against the JAX package's tools, on the same inputs, on the CPU.

Tolerances:
- the writers' files are held byte for byte: weak labels (.npy, on one
  host path on both sides: NumPy, and the native voxelizer where both
  packages' libraries loaded), manifests, PLY point clouds, panels and
  submission trees;
- predictions (visualize, infer) come from JAX-initialised float32
  SalsaNext variables carried across by ``state_dict_from_jax``; the
  forwards agree within 1e-4 (tests/test_torch_salsanext.py) and no argmax
  is that close to a tie at these inputs, so labels are held exactly;
- checkpoints: every tensor equal (torch.equal), the same keys;
- the ablation: arm configs equal field for field; merged reports equal
  as JSON; a port run's summary and paired deltas equal what the JAX
  tool's ``_write`` makes of the same runs;
- baseline_matrix: the dry-run plan equal once the port's module prefix,
  its ``--device`` and the converted checkpoint's ``.pth`` suffix (the JAX
  tool writes ``.msgpack``) are mapped back.
"""

import argparse
import dataclasses
import importlib.util
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coarse3d_tpu_torch.tools.convert_jax_params import state_dict_from_jax

KITTI_SET = ["sensor.proj_h=16", "sensor.proj_w=64", "data.max_points=4096",
             "model.compute_dtype=float32"]


def _randomize(tree, rng, leaf_fn):
    return {k: _randomize(v, rng, leaf_fn) if isinstance(v, dict)
            else leaf_fn(k, np.asarray(v), rng) for k, v in tree.items()}


def jax_variables(preset_name, n_classes, net="salsanext", seed=0):
    """A JAX model's variables at 16x64 as numpy trees, BatchNorm made
    non-trivial (so the label map is not constant)."""
    from coarse3d_tpu.configs import preset
    from coarse3d_tpu.train.setup import build_model

    cfg = preset(preset_name)
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, n_classes=n_classes),
        model=dataclasses.replace(cfg.model, net_type=net,
                                  compute_dtype="float32"))
    model = build_model(cfg)
    variables = model.init({"params": jax.random.key(seed)},
                           jnp.zeros((1, 16, 64, 5)), train=False,
                           return_feat=True)          # creates the projector
    rng = np.random.default_rng(seed)

    def stats(k, v, rng):
        if k == "mean":
            return rng.normal(0, 0.5, v.shape).astype(np.float32)
        return rng.uniform(0.5, 2.0, v.shape).astype(np.float32)

    def params(k, v, rng):
        if k == "scale":
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if k == "bias":
            return rng.normal(0, 0.1, v.shape).astype(np.float32)
        return v

    return {"params": _randomize(jax.device_get(variables["params"]), rng,
                                 params),
            "batch_stats": _randomize(
                jax.device_get(variables["batch_stats"]), rng, stats)}


def _weights(tmp_path, variables, net="salsanext"):
    """The same weights for both tools: a Flax .msgpack for JAX's, a port
    .pth (state_dict_from_jax) for the port's."""
    import flax.serialization

    msgpack = tmp_path / "w.msgpack"
    msgpack.write_bytes(flax.serialization.msgpack_serialize(variables))
    pth = tmp_path / "w.pth"
    torch.save(state_dict_from_jax(variables, net), pth)
    return str(msgpack), str(pth)


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


# -- gen_weak_labels ---------------------------------------------------------------

def _mini_kitti(root, rng, n_scans=2, n_pts=2000):
    from coarse3d_tpu_torch.data.label_maps import KITTI_LEARNING_MAP

    raw_ids = np.asarray([k for k, v in KITTI_LEARNING_MAP.items() if v > 0])
    seq = os.path.join(root, "00")
    os.makedirs(os.path.join(seq, "velodyne"))
    os.makedirs(os.path.join(seq, "labels"))
    for i in range(n_scans):
        rng.uniform(-30, 30, (n_pts, 4)).astype(np.float32).tofile(
            os.path.join(seq, "velodyne", f"{i:06d}.bin"))
        rng.choice(raw_ids, n_pts).astype(np.int32).tofile(
            os.path.join(seq, "labels", f"{i:06d}.label"))
    return ["--sequences", "0"]


def _mini_nuscenes(root, rng, n_scans=3, n_pts=3000):
    os.makedirs(os.path.join(root, "samples", "LIDAR_TOP"))
    os.makedirs(os.path.join(root, "lidarseg", "v1.0-mini"))
    with open(os.path.join(root, "manifest_train.jsonl"), "w") as f:
        for i in range(n_scans):
            pts = np.zeros((n_pts, 5), np.float32)
            pts[:, :3] = rng.uniform(-30, 30, (n_pts, 3))
            lidar = f"samples/LIDAR_TOP/tok{i}.bin"
            seg = f"lidarseg/v1.0-mini/tok{i}_lidarseg.bin"
            pts.tofile(os.path.join(root, lidar))
            rng.integers(1, 32, n_pts).astype(np.uint8).tofile(
                os.path.join(root, seg))
            f.write(json.dumps({"lidar": lidar, "lidarseg": seg,
                                "token": f"tok{i}"}) + "\n")
    return []


@pytest.mark.parametrize("dataset", ["semantic_kitti", "nuscenes"])
def test_gen_weak_labels_writes_the_jax_files(dataset, tmp_path, monkeypatch):
    """tests/test_tools.py:25-96 on both packages: the same .npy files byte
    for byte and the same per-class counts in the log. Each package picks
    its voxelizer (NumPy, or the native library) by whether its own
    library loaded, and the JAX package's build can lose a race between
    test workers: both sides run on one host path at a time (NumPy; then
    the native library, where both packages' libraries loaded). The port's
    tool, like the JAX one, takes no --device and needs no card."""
    from coarse3d_tpu import native as jnative
    from coarse3d_tpu.tools import gen_weak_labels as jgen
    from coarse3d_tpu_torch import native as tnative
    from coarse3d_tpu_torch.tools import gen_weak_labels as tgen

    root = str(tmp_path / "pcd")
    make = _mini_kitti if dataset == "semantic_kitti" else _mini_nuscenes
    extra = make(root, np.random.default_rng(0))
    both_native = jnative.available() and tnative.available()

    def run(tool, save):
        tool.main(["--dataset", dataset, "--dataset_root", root,
                   "--dataset_save", save, "--label_ratio", "0.01",
                   "--workers", "1", "--weak_label_name", "0.1"] + extra)
        files = _tree(save)
        (log,) = [k for k in files if k.startswith("log_")]
        counts = files.pop(log).split(b"per-class")[1]
        return files, counts

    paths = ["numpy"] + (["native"] if both_native else [])
    for path in paths:
        with monkeypatch.context() as m:
            if path == "numpy":
                # the JAX tool's workers are forked (they keep the patch);
                # the port's are spawned and read the environment
                m.setattr(jnative, "available", lambda: False)
                m.setenv("COARSE3D_NATIVE", "0")
            want = run(jgen, str(tmp_path / f"j_{path}"))
            got = run(tgen, str(tmp_path / f"t_{path}"))
        assert len(want[0]) == (2 if dataset == "semantic_kitti" else 3)
        assert got[0] == want[0], path
        assert got[1] == want[1], path


# -- build_nuscenes_manifest ------------------------------------------------------

def test_manifest_builder_writes_the_jax_manifest(tmp_path):
    """tests/test_aux.py::test_manifest_builder on both packages: equal
    manifests; neither finds the devkit (official_splits() is None)."""
    from coarse3d_tpu.tools import build_nuscenes_manifest as jman
    from coarse3d_tpu_torch.tools import build_nuscenes_manifest as tman

    version = "v1.0-mini"
    tdir = tmp_path / version
    tdir.mkdir()
    scenes = [{"token": f"sc{i}", "name": f"scene-{i:04d}"} for i in range(3)]
    samples = [{"token": f"sm{i}", "scene_token": f"sc{i % 3}"}
               for i in range(6)]
    sample_data = []
    for i in range(6):
        sample_data += [
            {"token": f"sd{i}", "sample_token": f"sm{i}", "is_key_frame": True,
             "filename": f"samples/LIDAR_TOP/frame{i}.pcd.bin"},
            {"token": f"sw{i}", "sample_token": f"sm{i}",
             "is_key_frame": False,
             "filename": f"sweeps/LIDAR_TOP/sweep{i}.pcd.bin"}]
    lidarseg = [{"sample_data_token": f"sd{i}",
                 "filename": f"lidarseg/{version}/sd{i}_lidarseg.bin"}
                for i in range(5)]          # one key frame without labels
    for name, data in [("scene", scenes), ("sample", samples),
                       ("sample_data", sample_data), ("lidarseg", lidarseg)]:
        (tdir / f"{name}.json").write_text(json.dumps(data))
    (tmp_path / "val.txt").write_text("scene-0002\n")

    assert jman.official_splits() is None and tman.official_splits() is None
    out = {}
    for name, tool in (("j", jman), ("t", tman)):
        tool.main(["--dataroot", str(tmp_path), "--version", version,
                   "--out_dir", str(tmp_path / name), "--val_scenes",
                   str(tmp_path / "val.txt"), "--weak_name", "weak_0.1"])
        out[name] = _tree(tmp_path / name)
    assert sorted(out["j"]) == ["manifest_train.jsonl", "manifest_val.jsonl"]
    assert out["t"] == out["j"]


# -- baseline_matrix ---------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["train", "--dataset", "all", "--extra_set", "model.stem=s2d",
     "--pretrained", "/ckpt/encoder"],
    ["eval", "--pth", "/ckpt/best.pth", "--dataset", "semantic_kitti"],
], ids=["train", "eval"])
def test_baseline_matrix_plans_the_jax_stages(argv, capsys):
    """tests/test_tools.py:460 on both packages: the dry run's plan is the
    JAX one once the port's module prefix, its --device and the converted
    checkpoint's suffix are mapped back; every stage names a port module,
    and every stage but the host-only weak-label sampling takes --device."""
    from coarse3d_tpu.tools.baseline_matrix import main as jmain
    from coarse3d_tpu_torch.tools.baseline_matrix import main as tmain

    common = ["--pcd_root", "/data", "--dry_run", "--work", "/nonexistent/w"]
    want_rows = jmain(argv + common)
    want = capsys.readouterr().out
    got_rows = tmain(argv + common + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert got_rows == want_rows
    lines = got.splitlines()
    stages = [line for line in lines if not line.startswith("#")]
    assert stages and all(
        line.endswith(" --device cpu")
        != (" coarse3d_tpu_torch.tools.gen_weak_labels " in line)
        for line in stages)
    mapped = "\n".join(
        re.sub(r"(converted/\S+)\.pth", r"\1.msgpack",
               line.removesuffix(" --device cpu")
               .replace("coarse3d_tpu_torch.tools.", "coarse3d_tpu.tools."))
        for line in lines) + "\n"
    assert mapped == want
    mods = {tok for line in stages for tok in line.split()
            if tok.startswith("coarse3d_tpu_torch.tools.")}
    assert mods and all(importlib.util.find_spec(m) for m in mods), mods


# -- visualize -----------------------------------------------------------------------

@pytest.fixture(scope="module")
def kitti_weights(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("kitti_weights")
    return _weights(tmp, jax_variables("semantic_kitti", 20))


def _panel(path):
    if path.endswith(".npy"):
        return np.load(path)
    from PIL import Image

    return np.asarray(Image.open(path))


@pytest.mark.parametrize("with_weights", [False, True],
                         ids=["no_weights", "weights"])
def test_visualize_writes_the_jax_images(with_weights, kitti_weights,
                                         tmp_path):
    """tests/test_tools.py:121 on both packages (scan, labels, weak labels,
    and with --weights the KNN prediction): the same panel, byte-equal PLY
    files."""
    from coarse3d_tpu.tools.visualize import main as jmain
    from coarse3d_tpu_torch.configs import preset
    from coarse3d_tpu_torch.data.label_maps import get_label_spec
    from coarse3d_tpu_torch.data.synthetic import synthetic_scan
    from coarse3d_tpu_torch.tools.visualize import main as tmain

    spec = get_label_spec("semantic_kitti")
    scan = synthetic_scan(np.random.default_rng(1), 3000, 20,
                          preset("tiny").sensor)
    scan["points"].astype(np.float32).tofile(tmp_path / "000000.bin")
    spec.unmap_labels(scan["labels"]).astype(np.uint32).tofile(
        tmp_path / "000000.label")
    np.save(tmp_path / "000000.npy", scan["weak_labels"])
    cfg_yaml = tmp_path / "cfg.yaml"
    cfg_yaml.write_text(json.dumps({
        "preset": "semantic_kitti", "data": {"max_points": 4096},
        "sensor": {"proj_h": 16, "proj_w": 64},
        "model": {"compute_dtype": "float32"}}))
    argv = ["--config", str(cfg_yaml), "--scan", str(tmp_path / "000000.bin"),
            "--label", str(tmp_path / "000000.label"),
            "--weak", str(tmp_path / "000000.npy")]
    msgpack, pth = kitti_weights
    jargs = argv + (["--weights", msgpack, "--knn"] if with_weights else [])
    targs = argv + (["--weights", pth, "--knn"] if with_weights else [])
    jpanel = jmain(jargs + ["--out", str(tmp_path / "j")])
    tpanel = tmain(targs + ["--out", str(tmp_path / "t"), "--device", "cpu"])
    assert os.path.basename(tpanel) == os.path.basename(jpanel)
    np.testing.assert_array_equal(_panel(tpanel), _panel(jpanel))
    plys = {k: v for k, v in _tree(tmp_path / "j").items()
            if k.endswith(".ply")}
    assert sorted(plys) == (["000000_gt.ply", "000000_pred.ply"]
                            if with_weights else ["000000_gt.ply"])
    for name, data in plys.items():
        assert (tmp_path / "t" / name).read_bytes() == data, name


# -- infer --submission --split -------------------------------------------------------

@pytest.mark.parametrize("dataset", ["semantic_kitti", "nuscenes"])
def test_infer_submission_writes_the_jax_tree(dataset, kitti_weights,
                                              tmp_path):
    """tools/infer.py --submission end to end (the JAX side's
    tests/test_tools.py:408 writes the same tree through evaluate): KITTI's
    sequences/NN/predictions tree, nuScenes' lidarseg/<split>/ files and
    submission.json under --split, byte for byte."""
    from coarse3d_tpu.tools.infer import main as jmain
    from coarse3d_tpu_torch.tools.infer import main as tmain

    rng = np.random.default_rng(2)
    if dataset == "semantic_kitti":
        msgpack, pth = kitti_weights
        scan_dir = tmp_path / "sequences" / "08" / "velodyne"
        cols, extra = 4, []
    else:
        msgpack, pth = _weights(tmp_path, jax_variables("nuscenes", 17))
        scan_dir = tmp_path / "samples"
        cols, extra = 5, ["--split", "test"]
    scan_dir.mkdir(parents=True)
    for i, n in enumerate((700, 1100, 901)):
        pts = (rng.normal(size=(n, cols)) * 10).astype(np.float32)
        pts.tofile(scan_dir / f"{i:06d}.bin")
    argv = (["--preset", dataset, "--scan_dir", str(scan_dir),
             "--batch_size", "2", "--submission"] + extra
            + [a for s in KITTI_SET for a in ("--set", s)])
    jmain(argv + ["--weights", msgpack, "--out", str(tmp_path / "j")])
    tmain(argv + ["--weights", pth, "--out", str(tmp_path / "t"),
                  "--device", "cpu"])
    want = _tree(tmp_path / "j")
    assert len(want) == (3 if dataset == "semantic_kitti" else 4)
    assert _tree(tmp_path / "t") == want


# -- convert_torch_ckpt / export_torch_ckpt ----------------------------------------

def _reference_pth(path, variables, net, drop=()):
    """A reference-style checkpoint of JAX variables (the JAX package's
    export_state_dict): nested under model_state, DataParallel's module.
    prefix, the prototype memory beside the layers."""
    from coarse3d_tpu.tools.convert_torch_ckpt import export_state_dict

    sd, missing = export_state_dict(variables, net)
    assert not missing
    sd["prototypes"] = np.ones((20, 4, 32), np.float32)
    torch.save({"model_state": {
        f"module.{k}": torch.from_numpy(np.ascontiguousarray(v))
        for k, v in sd.items() if not k.startswith(drop)}, "epoch": 7}, path)


@pytest.mark.parametrize("net", ["salsanext", "rangenet"])
def test_convert_torch_ckpt_matches_jax(net, tmp_path, capsys):
    """The port's convert_torch_ckpt output equals the JAX
    convert_state_dict followed by the port's state_dict_from_jax, loads
    strictly into the family's model, and a checkpoint short of a layer
    gets the JAX tool's warning."""
    from coarse3d_tpu.tools import convert_torch_ckpt as jconv
    from coarse3d_tpu_torch.tools import convert_torch_ckpt as tconv

    variables = jax_variables("semantic_kitti", 20, net=net)
    ref = tmp_path / "ref.pth"
    _reference_pth(ref, variables, net)
    want = state_dict_from_jax(
        jconv.convert_state_dict(jconv.load_torch_state_dict(str(ref)), net),
        net)
    out = tmp_path / "converted" / "model.pth"
    got = tconv.main(["--pth", str(ref), "--net", net, "--out", str(out),
                      "--device", "cpu"])
    written = torch.load(out, weights_only=True)
    assert list(written) == list(want) == list(got)
    assert all(torch.equal(written[k], v) for k, v in want.items())

    # a checkpoint short of its head: the same warning, no strict load
    head = "cls_head" if net == "salsanext" else "head.1"
    _reference_pth(ref, variables, net, drop=(f"{head}.",))
    capsys.readouterr()
    jconv.main(["--pth", str(ref), "--net", net,
                "--out", str(tmp_path / "j.msgpack")])
    jwarn = capsys.readouterr().out.splitlines()[0]
    tconv.main(["--pth", str(ref), "--net", net,
                "--out", str(tmp_path / "t.pth"), "--device", "cpu"])
    twarn = capsys.readouterr().out.splitlines()[0]
    assert twarn == jwarn and twarn.startswith("WARNING: 1 reference layers")


def test_export_torch_ckpt_from_msgpack_matches_jax(tmp_path):
    """export_torch_ckpt --msgpack on both packages (the JAX tool maps the
    variables through convert_torch_ckpt.py:export_state_dict): the same
    tensors under the same names, prototypes included, epoch None; an s2d
    stem is refused in the same words. The port's --msgpack path touches
    no device: left at its default --device, it runs without a card."""
    import flax.serialization

    from coarse3d_tpu.tools.export_torch_ckpt import main as jmain
    from coarse3d_tpu_torch.tools.export_torch_ckpt import main as tmain

    variables = jax_variables("semantic_kitti", 20)
    variables["prototypes"] = np.random.default_rng(3).normal(
        size=(20, 4, 32)).astype(np.float32)
    src = tmp_path / "v.msgpack"
    src.write_bytes(flax.serialization.msgpack_serialize(variables))
    common = ["--msgpack", str(src), "--net", "salsanext"]
    jmain(common + ["--out", str(tmp_path / "j.pth")])
    with pytest.MonkeyPatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        tmain(common + ["--out", str(tmp_path / "t.pth")])
    want = torch.load(tmp_path / "j.pth", weights_only=True)
    got = torch.load(tmp_path / "t.pth", weights_only=True)
    assert want["epoch"] is None and got["epoch"] is None
    assert sorted(got["model_state"]) == sorted(want["model_state"])
    for k, v in want["model_state"].items():
        assert torch.equal(got["model_state"][k], v), k

    s2d = tmp_path / "s2d.msgpack"
    s2d.write_bytes(flax.serialization.msgpack_serialize(
        {"params": {"cls_head_s2d": {"kernel": np.zeros((1, 1, 2, 2),
                                                        np.float32)}},
         "batch_stats": {}}))
    errors = []
    for main, dev in ((jmain, []), (tmain, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as err:
            main(["--msgpack", str(s2d), "--out", str(tmp_path / "x.pth")]
                 + dev)
        errors.append(str(err.value))
    assert errors[0] == errors[1] and "s2d stem" in errors[0]


def test_export_torch_ckpt_from_run_dir(tmp_path):
    """export_torch_ckpt --run_dir: the latest rolling checkpoint's model
    and memory in reference layout, epoch = the epoch a resumed run starts
    at (the JAX tool's), loading strictly through the port's --weights
    reader; convert_torch_ckpt of that file gives the model back."""
    from coarse3d_tpu_torch.configs import preset
    from coarse3d_tpu_torch.tools.convert_jax_params import (
        load_reference_state_dict,
    )
    from coarse3d_tpu_torch.tools import convert_torch_ckpt as tconv
    from coarse3d_tpu_torch.tools.export_torch_ckpt import main as tmain
    from coarse3d_tpu_torch.train.checkpoint import CheckpointManager
    from coarse3d_tpu_torch.train.setup import build_model, build_state

    cfg = preset("tiny")
    state = build_state(cfg, device="cpu", seed=5, steps_per_epoch=1)
    CheckpointManager(str(tmp_path / "run")).save_rolling(state, 2)
    sd, epoch = tmain(["--run_dir", str(tmp_path / "run"), "--preset",
                       "tiny", "--out", str(tmp_path / "m.pth"),
                       "--device", "cpu"])
    written = torch.load(tmp_path / "m.pth", weights_only=True)
    assert epoch == written["epoch"] == 3
    want = state.model.state_dict()
    assert sorted(written["model_state"]) == sorted(list(want)
                                                    + ["prototypes"])
    assert torch.equal(written["model_state"]["prototypes"], state.prototypes)
    model = build_model(cfg, device="cpu", seed=9)
    model.load_state_dict(load_reference_state_dict(str(tmp_path / "m.pth")),
                          strict=True)
    assert all(torch.equal(v, want[k]) for k, v in
               model.state_dict().items())
    # and convert_torch_ckpt gives every tensor back, step counts included
    back = tconv.main(["--pth", str(tmp_path / "m.pth"), "--net",
                       "salsanext", "--out", str(tmp_path / "c.pth"),
                       "--device", "cpu"])
    assert sorted(back) == sorted(want)
    assert all(torch.equal(v, want[k]) for k, v in back.items())


def test_flax_msgpack_reader_matches_flax():
    """tools/_flax_msgpack.py against flax.serialization.msgpack_restore on
    a real Flax file: SalsaNext's variables and the other leaves Flax
    writes (numpy scalars, strings, ints of each width, floats, booleans,
    nil); bfloat16 widened exactly; chunked arrays refused."""
    import flax.serialization

    from coarse3d_tpu_torch.tools._flax_msgpack import restore

    variables = jax_variables("tiny", 8)
    variables["extra"] = {
        "step": np.int64(7), "name": "x" * 40, "small": -3, "wide": 70000,
        "neg": -70000, "flag": True, "none": None, "rate": 0.5,
        "ints": np.arange(6, dtype=np.int32).reshape(2, 3)}
    blob = flax.serialization.msgpack_serialize(variables)
    want = flax.serialization.msgpack_restore(blob)
    got = restore(blob)

    def compare(a, b, path):
        if isinstance(b, dict):
            assert sorted(a) == sorted(b), path
            for k in b:
                compare(a[k], b[k], f"{path}/{k}")
        elif isinstance(b, (np.ndarray, np.generic)):
            assert a.dtype == b.dtype, path
            np.testing.assert_array_equal(a, b, err_msg=path)
        else:
            assert a == b and type(a) is type(b), path

    compare(got, want, "")
    bf16 = jnp.linspace(-2, 2, 7, dtype=jnp.bfloat16)
    widened = restore(flax.serialization.msgpack_serialize(
        {"a": np.asarray(bf16)}))["a"]
    assert widened.dtype == np.float32
    np.testing.assert_array_equal(widened, np.asarray(bf16, np.float32))
    with pytest.raises(ValueError, match="chunked"):
        restore(flax.serialization.msgpack_serialize(
            {"a": flax.serialization._chunk(np.zeros(3, np.float32))}))


# -- contrast_ablation -----------------------------------------------------------------

MERGE_ARGV = ["--epochs", "2", "--scans", "4", "--points", "100",
              "--classes", "4", "--weak", "0.01", "--segments", "4",
              "--modes", "1"]


def test_contrast_ablation_merge_matches_jax(tmp_path):
    """The merge case of tests/test_tools.py:573 on both packages: the
    config check refuses differing parts in the same words, and the merged
    reports are equal."""
    from coarse3d_tpu.tools.contrast_ablation import main as jmain
    from coarse3d_tpu_torch.tools.contrast_ablation import main as tmain

    base_cfg = {"epochs": 2, "scans": 4, "points": 100, "classes": 4,
                "weak": 0.01, "segments": 4, "modes": 1, "noise": 0.15,
                "label_noise": 0.0, "set": []}
    run = {"arm": "nocontrast", "seed": 1, "series": [0.1, 0.2],
           "best": 0.2, "last5": 0.15}
    parts = [(base_cfg, run),
             (dict(base_cfg, set=["contrast.proto_momentum=0.9"]),
              dict(run, arm="full", best=0.3)),
             (base_cfg, dict(run, arm="noproto", series=[0.05, 0.1],
                             best=0.1))]
    paths = []
    for i, (cfg, r) in enumerate(parts):
        paths.append(str(tmp_path / f"p{i}.json"))
        with open(paths[-1], "w") as f:
            json.dump({"config": cfg, "runs": [r]}, f)
    reports, errors = {}, {}
    for name, main in (("j", jmain), ("t", tmain)):
        out = ["--out", str(tmp_path / f"{name}.json")] + MERGE_ARGV
        with pytest.raises(SystemExit) as err:
            main(["--merge"] + paths[:2] + out)
        errors[name] = str(err.value).replace(name + ".json", "")
        reports[name] = main(["--merge"] + paths + ["--merge_exempt", "set"]
                             + out)
        reports[name]["config"].pop("out")
    assert errors["t"] == errors["j"] and "differs" in errors["j"]
    assert json.dumps(reports["t"]) == json.dumps(reports["j"])
    assert reports["t"]["paired"]["full-nocontrast"]["escape_delta"] == [0]


class _Captured(Exception):
    pass


def _arm_config(module, recorder_module, arm, monkeypatch):
    """The config ``run_one`` hands its Recorder for ``arm``, seed 3."""
    def capture(save_path, settings=None, **_):
        raise _Captured(settings)

    monkeypatch.setattr(recorder_module, "Recorder", capture)
    args = argparse.Namespace(
        classes=5, epochs=3, set=["train.lr=0.02"], weak=0.01, segments=4,
        modes=1, noise=0.15, label_noise=0.0, imbalance=0.5, scans=8,
        points=500, work="/nonexistent/w", num_workers=1)
    with pytest.raises(_Captured) as got:
        if module.__name__.startswith("coarse3d_tpu_torch"):
            module.run_one(arm, 3, args, torch.device("cpu"))
        else:
            module.run_one(arm, 3, args)
    return dataclasses.asdict(got.value.args[0])


def test_contrast_ablation_arms_match_jax(monkeypatch):
    """Every arm's applied config (preset, class count, seed, epochs, the
    arm's overrides, --set, the run's save path) equals the JAX tool's,
    field for field."""
    from coarse3d_tpu import utils as jutils
    from coarse3d_tpu.tools import contrast_ablation as jabl
    from coarse3d_tpu_torch import utils as tutils
    from coarse3d_tpu_torch.tools import contrast_ablation as tabl

    assert tabl.ARMS == jabl.ARMS
    for arm in jabl.ARMS:
        want = _arm_config(jabl, jutils, arm, monkeypatch)
        got = _arm_config(tabl, tutils, arm, monkeypatch)
        assert got == want, arm


def test_contrast_ablation_port_run_has_the_jax_report(tmp_path):
    """One 1-epoch run of two arms (full, nocontrast; contrast from epoch
    0) through the port's Trainer at 16x64 on the CPU: the report has the
    JAX tool's keys, and its summary and paired deltas are what the JAX
    tool's _write makes of the same runs."""
    from coarse3d_tpu.tools import contrast_ablation as jabl
    from coarse3d_tpu_torch.tools.contrast_ablation import main as tmain

    argv = ["--arms", "full", "nocontrast", "--seeds", "1", "--epochs", "1",
            "--scans", "4", "--points", "1500", "--classes", "4",
            "--weak", "0.01", "--segments", "4", "--modes", "1",
            "--num_workers", "1", "--work", str(tmp_path / "work"),
            "--out", str(tmp_path / "report.json"), "--device", "cpu"]
    for s in KITTI_SET[:3] + ["model.compute_dtype=float32",
                              "contrast.contrast_warmup=0",
                              "train.batch_size_train=2",
                              "train.batch_size_val=2"]:
        argv += ["--set", s]
    report = tmain(argv)
    with open(tmp_path / "report.json") as f:
        assert json.load(f) == json.loads(json.dumps(report))
    assert set(report) == {"config", "runs", "summary", "paired"}
    assert [(r["arm"], r["seed"]) for r in report["runs"]] == [
        ("full", 1), ("nocontrast", 1)]
    for r in report["runs"]:
        assert set(r) == {"arm", "seed", "series", "best", "last5",
                          "last5_class_iou", "escape_epoch"}
        assert len(r["series"]) == 1 and len(r["last5_class_iou"]) == 4
        assert 0.0 <= r["best"] <= 1.0
    assert os.path.isfile(tmp_path / "work" / "full_s1" / "checkpoint"
                          / "epoch_0000.pth")
    args = argparse.Namespace(**dict(report["config"],
                                          out=str(tmp_path / "j.json")))
    want = jabl._write(args, json.loads(json.dumps(report["runs"])))
    assert report["summary"] == want["summary"]
    assert report["paired"] == want["paired"]
