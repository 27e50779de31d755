"""Nothing a run imports is JAX or the JAX package, by top-level name, and
without a card the command fails loudly and prints no result."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

PROBE = """
import sys
sys.path.insert(0, {root!r})
import benchmark.run, benchmark.control, benchmark.check, benchmark.trace
import benchmark.drivers.serve, benchmark.drivers.train
import benchmark.reference.models, benchmark.reference.serve
import benchmark.reference.train, benchmark.reference.data
import benchmark.roofline.flops, benchmark.roofline.kernels
from benchmark import harness
man = harness.manifest()
for m in man["per_layer"]:
    harness.metric_module(m["name"])
# what the drivers import of the program
import coarse3d_tpu_torch.eval.inference, coarse3d_tpu_torch.train.setup
import coarse3d_tpu_torch.train.trainer, coarse3d_tpu_torch.data.pipeline
import coarse3d_tpu_torch.utils
print(sorted({{n.split(".")[0] for n in sys.modules}}))
"""


def test_nothing_imported_is_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, cwd=ROOT, timeout=300,
                         env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "coarse3d_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN), tops & set(harness.FORBIDDEN)


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module.split(".")[0])
    return names


def test_sources_import_no_forbidden_top_level_name():
    for path in (ROOT / "benchmark").rglob("*.py"):
        if "tests" not in path.parts:
            assert not set(_imports(path)) & set(harness.FORBIDDEN), path


def test_yardstick_imports_nothing_of_the_program():
    for sub in ("reference", "roofline"):
        for path in (ROOT / "benchmark" / sub).rglob("*.py"):
            assert not [n for n in _imports(path)
                        if n.startswith("coarse3d")], path
    assert not [n for n in _imports(ROOT / "benchmark" / "generate.py")
                if n.startswith("coarse3d")]


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "coarse3d_tpu_torch_fake", object())
    assert "coarse3d_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax"]


def test_without_a_card_the_command_refuses_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "salsanext-kitti.serve-b8", "--seed", str(2**31 + 5),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "refused" in out.stderr
    for line in out.stdout.splitlines():
        try:
            json.loads(line)
        except ValueError:
            continue
        raise AssertionError(f"printed a result: {line}")
