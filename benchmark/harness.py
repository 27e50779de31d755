"""What every cell shares: finding its files by name, the program's
configuration, weights made from the seed, the per-layer readers, the
device line, and the guard against JAX in the process.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``. Its files:
``benchmark/configs/<config>.json`` (the model configuration as it runs),
``benchmark/traffic/<traffic>.json`` (the mix's parameters, which name the
driver in ``benchmark/drivers/`` that generates it),
``benchmark/limits/<workload>.json`` (the limits of its correctness
numbers), for each per-layer metric it reports,
``benchmark/metrics/<metric>.py``, and, for a model family that
``benchmark/reference/models.py`` does not hold,
``benchmark/reference/<net_type>.py``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "coarse3d_tpu")
BN_GAIN = 0.8   # serving: calibrated BatchNorm gains damped, as trained maps


class Refused(RuntimeError):
    """The run cannot produce a result (no card, missing files)."""


def manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    if not path.is_file():
        raise Refused(f"missing {path}")
    with open(path) as f:
        return json.load(f)


def config(name: str, root: Path = ROOT) -> dict:
    return _json(root / "benchmark" / "configs" / f"{name}.json")


def traffic(name: str, root: Path = ROOT) -> dict:
    return _json(root / "benchmark" / "traffic" / f"{name}.json")


def limits(workload: str, root: Path = ROOT) -> dict:
    return _json(root / "benchmark" / "limits" / f"{workload}.json")


def metric_module(name: str, root: Path = ROOT):
    path = root / "benchmark" / "metrics" / f"{name}.py"
    if not path.is_file():
        raise Refused(f"missing {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(mix: dict):
    return importlib.import_module(f"benchmark.drivers.{mix['driver']}")


def cell(man: dict, name: str) -> dict:
    for wl in man["workloads"]:
        if wl["name"] == name:
            return wl
    raise Refused(f"no workload {name!r} in BENCHMARK.json")


def end_to_end(man: dict, wl: dict) -> list[dict]:
    return [m for m in man["end_to_end"]
            if "workloads" not in m or wl["name"] in m["workloads"]]


def per_layer(man: dict, wl: dict) -> list[dict]:
    e2e = {m["name"] for m in end_to_end(man, wl)}

    def reports(m):
        if "workloads" in m:
            return wl["name"] in m["workloads"]
        return m["moves"] in e2e

    return [m for m in man["per_layer"] if reports(m)]


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the run must not hold,
    compared whole: ``coarse3d_tpu_torch`` is not ``coarse3d_tpu``."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def program_config(cfg: dict, seed: int):
    """The program's ExperimentConfig: its preset, with every section key
    of the configuration file set as the file states it."""
    from coarse3d_tpu_torch.configs import preset

    out = preset(cfg["preset"])
    for section in ("data", "sensor", "augment", "contrast", "knn", "model",
                    "train"):
        block = getattr(out, section)
        names = {f.name for f in dataclasses.fields(block)}
        values = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in cfg.get(section, {}).items() if k in names}
        out = dataclasses.replace(out, **{
            section: dataclasses.replace(block, **values)})
    out = dataclasses.replace(out, train=dataclasses.replace(
        out.train, seed=seed))
    return out


def device_check(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise Refused("torch.cuda.is_available() is False: this benchmark "
                      "runs on the card only")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} cards, "
                      f"{torch.cuda.device_count()} present")


def device_info(chips: int, peak: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak)}


def make_weights(model, seed: int, device) -> None:
    """Every convolution's weight and bias uniform in +-1/sqrt(fan_in)
    (PyTorch's default scheme, fan_in = the weight's second dimension
    times its kernel), drawn on ``device`` in one call from a generator
    seeded with ``seed``; BatchNorm at scale 1, shift 0, statistics (0, 1)."""
    import torch

    fills = []
    for mod in model.modules():
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            bound = 1.0 / mod.weight[0].numel() ** 0.5
            fills += [(t, bound) for t in (mod.weight, mod.bias)
                      if t is not None]
        elif isinstance(mod, torch.nn.BatchNorm2d):
            mod.reset_parameters()
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(t.numel() for t, _ in fills)
    flat = torch.rand(total, generator=gen, device=device)
    with torch.no_grad():
        off = 0
        for t, bound in fills:
            n = t.numel()
            t.copy_((flat[off:off + n] * (2 * bound) - bound).view_as(t))
            off += n


def memory_init(c: int, k: int, d: int, seed: int, device):
    """Prototype memory: truncated normal (+-2) x 0.02, the reference's
    ``trunc_normal_`` init, drawn on ``device``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((c, k, d), generator=gen, device=device)
    bad = x.abs() > 2
    while bool(bad.any()):
        x = torch.where(bad, torch.randn((c, k, d), generator=gen,
                                         device=device), x)
        bad = x.abs() > 2
    return x * 0.02


def read_per_layer(man: dict, wl: dict, ctx: dict, root: Path = ROOT) -> dict:
    """The cell's per-layer metrics, each from its own reader; a reader
    that finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in per_layer(man, wl):
        value = metric_module(m["name"], root).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
