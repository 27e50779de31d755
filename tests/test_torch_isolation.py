"""The PyTorch port stands alone: importing coarse3d_tpu_torch and every
submodule loads neither jax nor any module of the JAX package; no source
file of the port names them; entry points refuse to run without a card
unless the caller asks for the CPU; and the port's copies of the JAX
package's framework-free modules still agree with their originals."""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import coarse3d_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(coarse3d_tpu_torch.__file__))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import coarse3d_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "coarse3d_tpu"))
print(len(names), bad)
"""


def test_import_loads_no_jax():
    """Run in a fresh interpreter: conftest.py has already imported jax."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 20, out.stdout       # every submodule was imported
    assert bad == "[]", bad


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|flax|optax)\b|from\s+(jax|flax|optax)\b)"
    r"|\bcoarse3d_tpu\b(?!_torch)", re.M)


def test_sources_name_no_jax():
    hits = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    for m in _FORBIDDEN.finditer(fh.read()):
                        hits.append(f"{os.path.relpath(path, REPO)}: {m[0]!r}")
    assert not hits, hits


@pytest.mark.parametrize("entry", ["resolve_device", "build_model", "infer",
                                   "build_state"])
def test_entry_points_default_to_cuda(entry, monkeypatch, tmp_path):
    """With device left at its default, an entry point raises without a
    card; device='cpu' runs."""
    from coarse3d_tpu_torch.configs import preset
    from coarse3d_tpu_torch.device import resolve_device
    from coarse3d_tpu_torch.train.setup import build_model, build_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = preset("tiny")
    if entry == "resolve_device":
        call = resolve_device
        assert resolve_device("cpu").type == "cpu"
    elif entry == "build_model":
        def call():
            return build_model(cfg)
        assert build_model(cfg, device="cpu") is not None
    elif entry == "build_state":
        def call():
            return build_state(cfg)
        assert build_state(cfg, device="cpu").prototypes.device.type == "cpu"
    else:
        from coarse3d_tpu_torch.tools.infer import main

        scan = tmp_path / "0.bin"
        np.zeros((10, 4), np.float32).tofile(scan)

        def call():
            main(["--preset", "tiny", "--weights", "unused.pth",
                  "--scans", str(scan), "--out", str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_config_copy_matches_jax():
    """Every preset, and CLI overrides, give the same config in both."""
    from coarse3d_tpu.configs import config as jcfg
    from coarse3d_tpu_torch.configs import config as tcfg

    for name in ("tiny", "kitti", "poss", "nuscenes", "nuscenes_32"):
        assert (dataclasses.asdict(tcfg.preset(name))
                == dataclasses.asdict(jcfg.preset(name))), name
    sets = ["train.lr=0.02", "model.stem=s2d", "data.cls_counts=[0,1,2]"]
    assert (dataclasses.asdict(tcfg.apply_overrides(tcfg.preset("kitti"), sets))
            == dataclasses.asdict(
                jcfg.apply_overrides(jcfg.preset("kitti"), sets)))


def test_data_copies_match_jax(tmp_path):
    from coarse3d_tpu.data import label_maps as jlm
    from coarse3d_tpu.data import readers as jrd
    from coarse3d_tpu.data import synthetic as jsyn
    from coarse3d_tpu_torch.configs import preset
    from coarse3d_tpu_torch.data import label_maps as tlm
    from coarse3d_tpu_torch.data import readers as trd
    from coarse3d_tpu_torch.data import synthetic as tsyn

    sensor = preset("kitti").sensor
    got = tsyn.synthetic_scan(np.random.default_rng(0), 5000, 20, sensor)
    want = jsyn.synthetic_scan(np.random.default_rng(0), 5000, 20, sensor)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for a, b in zip(tsyn.pad_points(got["points"], 6000),
                    jsyn.pad_points(got["points"], 6000)):
        np.testing.assert_array_equal(a, b)
    for ds in ("semantic_kitti", "semantic_poss", "nuscenes"):
        t, j = tlm.get_label_spec(ds), jlm.get_label_spec(ds)
        assert t.class_names == j.class_names
        np.testing.assert_array_equal(t.lut, j.lut)
        np.testing.assert_array_equal(t.lut_inv, j.lut_inv)
    path = tmp_path / "scan.bin"
    np.arange(40, dtype=np.float32).tofile(path)
    np.testing.assert_array_equal(trd.read_kitti_scan(str(path)),
                                  jrd.read_kitti_scan(str(path)))
    np.testing.assert_array_equal(trd.read_nuscenes_scan(str(path)),
                                  jrd.read_nuscenes_scan(str(path)))


def test_training_data_copies_match_jax():
    """synthetic_batch on the same seed, the host projection
    (range_project_np, both mask conventions, a doctored depth) and
    scatter_labels_np, and focal_alpha_from_counts: equal to the originals."""
    from coarse3d_tpu.data import synthetic as jsyn
    from coarse3d_tpu.losses import focal as jfocal
    from coarse3d_tpu.ops import projection as jproj
    from coarse3d_tpu_torch.configs import preset
    from coarse3d_tpu_torch.data import synthetic as tsyn
    from coarse3d_tpu_torch.losses import focal as tfocal
    from coarse3d_tpu_torch.ops import projection as tproj

    for name in ("tiny", "poss"):
        cfg = preset(name)
        got = tsyn.synthetic_batch(np.random.default_rng(2), cfg, 2,
                                   n_points=3000, weak_ratio=0.01)
        want = jsyn.synthetic_batch(np.random.default_rng(2), cfg, 2,
                                    n_points=3000, weak_ratio=0.01)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    sensor = preset("kitti").sensor
    scan = tsyn.synthetic_scan(np.random.default_rng(3), 4000, 20, sensor)
    depth = np.random.default_rng(4).uniform(1, 50, 4000)
    for kw in ({}, {"mask_excludes_point0": False}, {"depth": depth}):
        got = tproj.range_project_np(scan["points"], sensor, **kw)
        want = jproj.range_project_np(scan["points"], sensor, **kw)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(
        tproj.scatter_labels_np(got["proj_idx"], scan["labels"]),
        jproj.scatter_labels_np(got["proj_idx"], scan["labels"]))
    for counts in (preset("kitti").data.cls_counts, (0.0, 1.0, 5.0)):
        np.testing.assert_array_equal(tfocal.focal_alpha_from_counts(counts),
                                      jfocal.focal_alpha_from_counts(counts))


def test_chip_smoke_imports_no_jax_and_needs_a_card(tmp_path):
    """chip_smoke.py names no JAX import, and without a card (or alone in
    a directory) it exits non-zero and prints no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    with open(script) as f:
        src = f.read()
    assert not re.search(
        r"^\s*(import\s+(jax|flax|optax)\b|from\s+(jax|flax|optax)\b"
        r"|import\s+coarse3d_tpu\b(?!_torch)|from\s+coarse3d_tpu\b(?!_torch))",
        src, re.M)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(src)
    for cwd, path in ((REPO, script), (tmp_path, str(alone))):
        out = subprocess.run([sys.executable, path], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


# -- the run loop's copies -------------------------------------------------------

def _code(tree):
    """An AST's dump with docstrings dropped and the JAX package's name
    rewritten to the port's."""
    import ast

    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(getattr(body[0], "value", None), ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return re.sub(r"\bcoarse3d_tpu\b", "coarse3d_tpu_torch", ast.dump(tree))


def _module_ast(package, rel):
    import ast

    with open(os.path.join(REPO, package, rel)) as f:
        return ast.parse(f.read())


@pytest.mark.parametrize("rel", [
    "data/readers.py", "data/datasets.py", "data/synthetic.py",
    "data/camera.py",
    "utils/__init__.py", "utils/meters.py", "utils/recorder.py",
    "visualizer/__init__.py", "visualizer/vis.py", "eval/submission.py",
])
def test_copied_modules_equal_their_originals(rel):
    """Whole-module copies: the same code but for docstrings, comments and
    the package's name."""
    assert (_code(_module_ast("coarse3d_tpu_torch", rel))
            == _code(_module_ast("coarse3d_tpu", rel)))


@pytest.mark.parametrize("rel, names", [
    ("data/pipeline.py", ["_tag_pixels", "_pad_tail_batch"]),
    # augment_pointcloud casts before its rotation product (the GIL): its
    # outputs are held equal in tests/test_torch_data.py instead
    ("data/augment.py", ["_euler_zyx_matrix"]),
    ("native/__init__.py", ["get_lib", "available", "range_project_native",
                            "scatter_labels_native", "voxelize_native"]),
    ("train/trainer.py", ["fit", "install_signal_handlers"]),
    ("tools/contrast_ablation.py", ["_sign_flip_perm_p", "_escape_epoch",
                                    "_write"]),
    ("tools/gen_weak_labels.py", ["voxelize", "sample_weak_labels",
                                  "_process_scan", "_nuscenes_weak_path",
                                  "_nuscenes_jobs"]),
    ("tools/build_nuscenes_manifest.py", ["load_table", "build_records",
                                          "official_splits"]),
    ("tools/baseline_matrix.py", ["_run", "_write_report"]),
])
def test_copied_functions_equal_their_originals(rel, names):
    """Copies inside modules that otherwise differ: each named function or
    class is the original's, docstrings and the package's name aside."""
    import ast

    def named(package):
        out = {}
        for node in ast.walk(_module_ast(package, rel)):
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                out.setdefault(node.name, node)
        return out

    port, orig = named("coarse3d_tpu_torch"), named("coarse3d_tpu")
    for name in names:
        assert _code(port[name]) == _code(orig[name]), name


def test_run_loop_cli_flags_cover_the_originals():
    """tools/train.py and tools/evaluate.py take every flag of the JAX
    package's tools (read from the sources), plus --device."""
    def flags(package, rel):
        with open(os.path.join(REPO, package, rel)) as f:
            return set(re.findall(r'add_argument\(\s*"(--\w+)"', f.read()))

    for rel in ("tools/train.py", "tools/evaluate.py", "tools/infer.py",
                "tools/train_crf.py"):
        port, orig = flags("coarse3d_tpu_torch", rel), flags("coarse3d_tpu", rel)
        assert orig <= port, (rel, sorted(orig - port))
        assert "--device" in port - orig, rel


@pytest.mark.parametrize("net,layers", [
    ("salsanext", 21), ("rangenet", 21), ("rangenet", 53),
    ("squeezesegv3", 21), ("squeezesegv3", 53)])
def test_converter_entry_tables_match_jax(net, layers):
    """The port's own copies of the checkpoint converter's entry tables
    (kind, reference name, Flax path) equal the JAX package's, row for row,
    and so do the block counts of both depths."""
    from coarse3d_tpu.models import rangenet as jrange
    from coarse3d_tpu.tools import convert_torch_ckpt as jconv
    from coarse3d_tpu_torch.models import rangenet as trange
    from coarse3d_tpu_torch.tools import convert_jax_params as tconv

    want = [(e.kind, e.torch_prefix, e.flax_path)
            for e in jconv._ENTRIES[net](layers)]
    assert tconv._ENTRIES[net](layers) == want
    assert trange.MODEL_BLOCKS == jrange.MODEL_BLOCKS == tconv._BLOCKS
    assert trange.BN_MOM == pytest.approx(1.0 - jrange.BN_MOM)


def test_new_modules_are_imported_by_the_walk():
    """The modules of the other families, the post-processing, the
    multi-GPU data path and the small copies are part of the package that
    test_import_loads_no_jax walks."""
    import pkgutil

    names = {m.name for m in pkgutil.walk_packages(
        coarse3d_tpu_torch.__path__, coarse3d_tpu_torch.__name__ + ".")}
    for mod in ("models.rangenet", "models.squeezesegv3", "postproc",
                "postproc.crf", "postproc.border", "tools.train_crf",
                "parallel", "parallel.mesh", "data.camera",
                "utils.tensor_ops", "entry", "tools._flax_msgpack",
                *(f"tools.{t}" for t in NEW_TOOLS)):
        assert f"coarse3d_tpu_torch.{mod}" in names, mod


# the tools ported last, and the device each runs on; the two that only
# read and write files on the host take no --device, as their JAX originals
# run on any data-preparation machine
NEW_TOOLS = ("contrast_ablation", "gen_weak_labels", "build_nuscenes_manifest",
             "baseline_matrix", "visualize", "convert_torch_ckpt",
             "export_torch_ckpt")
HOST_TOOLS = ("gen_weak_labels", "build_nuscenes_manifest")


@pytest.mark.parametrize("tool", NEW_TOOLS)
def test_tool_cli_flags_cover_the_originals(tool):
    """Each tool takes every flag of the JAX package's, and --device, but
    for the host-only tools (HOST_TOOLS), which take exactly the JAX
    flags."""
    def flags(package):
        with open(os.path.join(REPO, package, "tools", f"{tool}.py")) as f:
            return set(re.findall(r'add_argument\(\s*"(--\w+)"', f.read()))

    port, orig = flags("coarse3d_tpu_torch"), flags("coarse3d_tpu")
    assert orig <= port, sorted(orig - port)
    if tool in HOST_TOOLS:
        assert port == orig
    else:
        assert "--device" in port - orig


def test_project_listing_has_a_counterpart_for_every_module():
    """Every module of the JAX package has its counterpart in the port;
    the port's only other modules are its own additions, and the Pallas
    kernels live in ops/{proj_scatter,knn_vote,proto_update}.py."""
    def listing(package):
        root = os.path.join(REPO, package)
        return {os.path.relpath(os.path.join(d, f), root)
                for d, _, files in os.walk(root) for f in files
                if f.endswith(".py")}

    jax_mods = {m for m in listing("coarse3d_tpu")
                if not m.startswith("ops/pallas/")}
    port = listing("coarse3d_tpu_torch")
    assert jax_mods - port == set()
    assert port - jax_mods == {
        "device.py", "entry.py", "ops/_build.py", "ops/proj_scatter.py",
        "ops/knn_vote.py", "ops/proto_update.py",
        "tools/convert_jax_params.py", "tools/_flax_msgpack.py",
        "utils/profiling.py"}


@pytest.mark.parametrize("tool, argv", [
    ("contrast_ablation", ["--arms", "full", "--seeds", "1"]),
    ("baseline_matrix", ["train", "--pcd_root", "x", "--dry_run"]),
    ("visualize", ["--scan", "x.bin", "--out", "y"]),
    ("convert_torch_ckpt", ["--pth", "x.pth", "--out", "y.pth"]),
    ("export_torch_ckpt", ["--run_dir", "x", "--out", "y.pth"]),
])
def test_new_tools_default_to_the_card(tool, argv, monkeypatch, capsys):
    """Left at its default --device, each tool that runs a model raises
    without a card before it reads or writes anything (baseline_matrix's
    dry run names --device cuda in every stage that runs a model, where
    the stage raises; export_torch_ckpt's --msgpack path, which touches no
    device, runs without one: tests/test_torch_tools.py)."""
    import importlib

    main = importlib.import_module(f"coarse3d_tpu_torch.tools.{tool}").main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if tool == "baseline_matrix":
        assert main(argv)["dry_run"]
        stages = [line for line in capsys.readouterr().out.splitlines()
                  if not line.startswith("#")]
        assert stages and all(
            line.endswith(" --device cuda")
            != (" coarse3d_tpu_torch.tools.gen_weak_labels " in line)
            for line in stages)
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)


def test_batch_keys_and_config_surface_match():
    from coarse3d_tpu.data import pipeline as jpipe
    from coarse3d_tpu.models import salsanext as jsalsa
    from coarse3d_tpu_torch.data import pipeline as tpipe
    from coarse3d_tpu_torch.models import salsanext as tsalsa

    assert tpipe.BATCH_KEYS == jpipe.BATCH_KEYS
    assert len(tsalsa.ENCODER_PREFIXES) == len(jsalsa.ENCODER_PREFIXES) == 2


def test_kernel_sources_are_all_built_by_chip_smoke():
    """Every CUDA source of the port is named in chip_smoke.py's kernels
    line, and csrc/ holds nothing but those sources."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        smoke = f.read()
    csrc = os.path.join(PKG, "csrc")
    sources = os.listdir(csrc)
    assert sources and all(f.endswith(".cu") for f in sources), sources
    for f in sources:
        assert f"coarse3d_tpu_torch/csrc/{f}" in smoke, f
