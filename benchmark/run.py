"""Run one cell of the benchmark of ``coarse3d_tpu_torch`` on the card.

  python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
      --trace <0|1>

from the root of a checkout. It loads the cell's configuration and mix
(``benchmark/README.md``), makes its inputs and weights from the seed,
warms up, measures for ``--seconds``, checks what the timed path produced
against the plain reference, and prints one JSON line last: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics. Without a card, or with fewer cards than the cell asks
for, it exits with status 2 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _environment() -> None:
    """Build and kernel caches at fixed places inside the checkout; one
    thread for each numerical library's pool, so that the data pipeline's
    worker threads do not each start a pool of their own."""
    cache = ROOT / "benchmark" / ".cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    for name in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(name, "1")


def mark(t0: float, what: str) -> None:
    """Seconds since the process started, on standard error."""
    print(f"at {time.perf_counter() - t0:.3f} s: {what}", file=sys.stderr,
          flush=True)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path = ROOT, t0: float | None = None,
             hooks: dict | None = None, cfg_patch=None, mix_patch=None
             ) -> dict:
    """The result line's fields for one run. ``device``, ``hooks`` and the
    patches let the CPU tests drive a small copy of a run with the
    program broken underneath; the command line always runs on the card."""
    from benchmark import check, harness

    man = harness.manifest(root)
    wl = harness.cell(man, workload)
    cfg = harness.config(wl["config"], root)
    mix = harness.traffic(wl["traffic"], root)
    lim = harness.limits(workload, root)
    if cfg_patch:
        cfg = cfg_patch(cfg)
    if mix_patch:
        mix = mix_patch(mix)
    run_dir = root / "benchmark" / ".run" / workload
    run_dir.mkdir(parents=True, exist_ok=True)
    t0 = T0 if t0 is None else t0
    ctx = {"cfg": cfg, "mix": mix, "seed": seed, "seconds": seconds,
           "trace": trace, "device": device, "run_dir": run_dir, "t0": t0,
           "mark": lambda what: mark(t0, what), **(hooks or {})}
    out = harness.driver(mix).run(ctx)

    found = harness.forbidden_modules()
    if found:
        raise harness.Refused(f"the run loaded {found}")
    correct, checks = check.judge(out["numbers"], lim)
    names = {m["name"] for m in harness.end_to_end(man, wl)}
    if trace:
        layer_ctx = dict(out["layer_ctx"], trace=out["trace"])
        metrics = harness.read_per_layer(man, wl, layer_ctx, root)
    else:
        metrics = {}
        units = {m["name"]: m["unit"] for m in man["end_to_end"]}
        for name, value in out["metrics"].items():
            if name in names:
                metrics[name] = {"value": value, "unit": units[name]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics}
    if device == "cuda":
        result["device"] = harness.device_info(wl["chips"], out["peak"])
    else:
        result["device"] = {"platform": "cpu", "count": 1,
                            "memory_peak_bytes": 0}
    if trace and out["trace"]:
        t = out["trace"]
        result["device"]["busy_s"] = t["busy_s"]
        result["device"]["window_s"] = t["window_s"]
        result["breakdown"] = {"device_ops": t["device_ops"],
                               "idle_gaps": t["idle_gaps"]}
    result["checks"] = checks
    print(f"samples: {out['samples']} (batches or steps in the window)",
          file=sys.stderr)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()
    from benchmark import harness

    try:
        wl = harness.cell(harness.manifest(), args.workload)
        harness.device_check(wl["chips"])
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace))
    except harness.Refused as exc:
        print(f"refused: {exc}", file=sys.stderr)
        return 2
    checks = result["checks"]
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
