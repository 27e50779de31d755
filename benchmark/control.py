"""Readings that set the correctness limits, at a cell's own sizes.

  python3 benchmark/control.py --workload <name> --seeds 11 12 13

For each seed it makes the cell's inputs and weights as a run does and
puts the plain reference in the program's place in the precision below
the configuration's: the bf16 backbone becomes float8 e4m3 convolutions
(``reference/models.py:set_fp8``). A serving cell reads the share of
valid points whose labels the float8 reference changes against the
float32 one; a training cell reads its numbers (``check.py``) for the
float8 reference, and for the planted faults "half of the batch left out,
the mean taken over the rest" and "each step returns its state
unchanged", against the float32 reference's first three steps. These readings are the upper ends the limits are set below
(``benchmark/limits/``). The benchmark's own runs do not run this.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def first_batches(seed: int, n: int, batch: int, steps: int):
    """(epoch, scan indices) of the first steps, in the order the
    program's pipeline shuffles an epoch (a permutation drawn from
    ``np.random.default_rng((seed, epoch))``, cut into batches)."""
    import numpy as np

    order = np.random.default_rng((seed, 0)).permutation(n)
    return [(0, order[i * batch:(i + 1) * batch]) for i in range(steps)]


def serve_readings(seed: int, cfg: dict, mix: dict, dev) -> dict:
    from benchmark.drivers import serve
    from benchmark.reference import models as rm

    pool = serve.make_pool(seed, cfg, mix)
    ref = serve.make_reference(seed, cfg, mix, dev)
    keys = range(len(pool))
    want = {i: serve.reference_labels(ref, pool[i], cfg, dev) for i in keys}
    rm.set_fp8(ref, True)
    low = {i: serve.reference_labels(ref, pool[i], cfg, dev) for i in keys}
    again = {i: serve.reference_labels(ref, pool[i], cfg, dev) for i in keys}
    return {"fp8": serve.mismatch_numbers(again, want, low, pool)}


def train_readings(seed: int, cfg: dict, mix: dict, dev) -> dict:
    from benchmark import generate, harness
    from benchmark.check import train_numbers
    from benchmark.drivers import train
    from benchmark.reference import models as rm

    con = cfg["contrast"]
    n_classes = cfg["data"]["n_classes"]
    catalog = train.Catalog(generate.scans(seed, 0, mix["catalog"], mix, cfg),
                            mix["epoch_scans"])
    ref = rm.build(cfg["model"], n_classes, con["proj_dim"]).to(dev)
    harness.make_weights(ref, seed, dev)
    theta0 = {n: p.detach().clone() for n, p in ref.named_parameters()}
    memory0 = harness.memory_init(n_classes, con["sub_proto_size"],
                                  con["proj_dim"], seed + 1, dev)
    fed = first_batches(seed, mix["epoch_scans"], mix["batch"],
                        train.CHECKED_STEPS)

    def steps(**kw):
        return train.reference_steps(ref, theta0, memory0, catalog, fed, cfg,
                                     mix, seed, dev, **kw)

    base = steps()
    again = steps()
    return {"float32_twice": train_numbers(again, base),
            "fp8": train_numbers(steps(fp8=True), base),
            "half_batch": train_numbers(
                steps(keep_batch=mix["batch"] // 2), base),
            "state_unchanged": train_numbers(steps(unchanged=True), base)}


def readings(workload: str, seed: int, dev: str = "cuda", root: Path = ROOT,
             cfg_patch=None, mix_patch=None) -> dict:
    import torch

    from benchmark import harness
    from benchmark.reference import models as rm

    man = harness.manifest(root)
    wl = harness.cell(man, workload)
    cfg = harness.config(wl["config"], root)
    mix = harness.traffic(wl["traffic"], root)
    if cfg_patch:
        cfg = cfg_patch(cfg)
    if mix_patch:
        mix = mix_patch(mix)
    rm.float32_math()
    fn = {"serve": serve_readings, "train": train_readings}[mix["driver"]]
    return fn(seed, cfg, mix, torch.device(dev))


def main(argv=None) -> int:
    import argparse

    from benchmark import harness

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    wl = harness.cell(harness.manifest(), args.workload)
    harness.device_check(wl["chips"])
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **readings(args.workload, seed)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
