"""Weakly supervised training: one rank's share of the reference recipe.

The program's ``Trainer.run_epoch(..., "Train")`` runs with validation
and checkpoints off, fed by the program's ``DataPipeline`` (augmentation
and host projection in its worker threads) over a catalog of seeded scans
held in host memory, the stand-in for the page cache. The pipeline is
handed to the Trainer through :class:`Stream`, which joins its epochs into
one stream and ends an epoch after a number of batches or at a deadline:
that is how the window ends at a step boundary without touching the
program.

The mix file gives ``batch``, ``catalog`` (distinct raw scans),
``epoch_scans`` (the catalog's entries: a KITTI training split, so an
epoch never ends inside a run and the schedule warms up as in a real
run), the points a scan, ``workers`` and ``prefetch`` of the pipeline,
``warmup_steps`` and ``trace_steps``.

Set-up builds the Trainer once, loads the weights and memory drawn on the
card from the seed, and drives it through its first three steps, one
epoch of one step each, recording each step's loss, the first gradient
as AdamW holds it, and the parameters and memory after the third; the
same Trainer then serves the window. After the window the plain reference
takes the same three steps from the same weights, memory, raw scans and
noise seed.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

CHECKED_STEPS = 3


class Catalog:
    """An epoch's worth of scans in host memory, the stand-in for the page
    cache: ``size`` entries backed by the distinct raw scans in turn (the
    pipeline augments each entry with its own draws); each load hands out
    copies, as a file read would."""

    name = "benchmark"

    def __init__(self, scans: list[dict], size: int):
        self.scans = scans
        self.size = size

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, index: int) -> dict:
        return self.scans[index % len(self.scans)]

    def load(self, index: int) -> dict:
        return {k: v.copy() for k, v in self[index].items()}


class Stream:
    """The program's pipeline as one stream of batches over its epochs."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.dataset = pipe.dataset
        self.limit: int | None = None
        self.deadline: float | None = None
        self.on_batch = None
        self._it = self._all()

    def _all(self):
        epoch = 0
        while True:
            for batch in self.pipe.epoch(epoch):
                yield epoch, batch
            epoch += 1

    def steps_per_epoch(self) -> int:
        return self.pipe.steps_per_epoch()

    def epoch(self, _epoch: int = 0):
        n = 0
        while ((self.limit is None or n < self.limit)
               and (self.deadline is None
                    or time.perf_counter() < self.deadline)):
            epoch, batch = next(self._it)
            if self.on_batch is not None:
                self.on_batch(epoch, batch)
            n += 1
            yield batch


def k3_rows(train_label: np.ndarray, n_classes: int, budget: int,
            ignore: int = 0) -> int:
    """Valid rows the prototype update hands K3: per class, its weak
    pixels up to the budget."""
    counts = np.bincount(train_label.reshape(-1), minlength=n_classes)
    return int(sum(min(int(counts[c]), budget) for c in range(n_classes)
                   if c != ignore))


def _norms(named) -> dict:
    return {n: float(t.float().norm()) for n, t in named}


def run(ctx: dict) -> dict:
    import torch

    from benchmark import generate, harness
    from benchmark.check import train_numbers
    from benchmark.reference import models as rm
    from benchmark.trace import Tracer
    from coarse3d_tpu_torch.data.pipeline import DataPipeline
    from coarse3d_tpu_torch.train.trainer import Trainer
    from coarse3d_tpu_torch.utils import Recorder

    cfg, mix, seed = ctx["cfg"], ctx["mix"], ctx["seed"]
    dev = torch.device(ctx["device"])
    rm.float32_math()
    n_classes = cfg["data"]["n_classes"]
    con = cfg["contrast"]
    bsz = mix["batch"]

    ctx["mark"]("imports done")
    raw = generate.scans(seed, 0, mix["catalog"], mix, cfg)
    ctx["mark"]("scans made")
    pcfg = dataclasses.replace(harness.program_config(cfg, seed),
                               save_path=str(ctx["run_dir"]))
    catalog = Catalog(raw, mix["epoch_scans"])
    pipe = DataPipeline(catalog, pcfg, batch_size=bsz, train=True,
                        seed=seed, num_workers=mix["workers"],
                        prefetch=mix["prefetch"],
                        pin_memory=dev.type == "cuda")
    stream = Stream(pipe)
    trainer = ctx.get("trainer_cls", Trainer)(
        pcfg, stream, None,
        recorder=Recorder(str(ctx["run_dir"]), enabled=False), device=dev)

    ctx["mark"]("trainer built")
    ref = rm.build(cfg["model"], n_classes, con["proj_dim"]).to(dev)
    harness.make_weights(ref, seed, dev)
    state = trainer.state
    state.model.load_state_dict(ref.state_dict())
    memory0 = harness.memory_init(n_classes, con["sub_proto_size"],
                                  con["proj_dim"], seed + 1, dev)
    state.prototypes = memory0.clone()
    theta0 = {n: p.detach().clone() for n, p in ref.named_parameters()}
    ref.cpu()

    # the first steps, through the window's own call and feed
    fed: list[tuple[int, np.ndarray]] = []
    stream.on_batch = lambda epoch, b: fed.append(
        (epoch, b["scan_index"].copy()))
    stream.limit = 1
    prog = {"losses": []}
    beta1 = state.optimizer.param_groups[0]["betas"][0]
    for s in range(CHECKED_STEPS):
        trainer.run_epoch(0, "Train")
        prog["losses"].append(trainer.history[-1]["loss"]["total"])
        if s == 0:
            opt_state = trainer.state.optimizer.state
            prog["grad"] = {
                n: float(opt_state[p]["exp_avg"].norm()) / (1 - beta1)
                if p in opt_state else 0.0
                for n, p in trainer.state.model.named_parameters()}
    ctx["mark"]("first steps done")
    model = trainer.state.model
    prog["change"] = _norms((n, p.detach() - theta0[n].to(p.device))
                            for n, p in model.named_parameters())
    prog["memory"] = trainer.state.prototypes.detach().clone()
    checked = list(fed)
    stream.on_batch = None

    stream.limit = mix["warmup_steps"]
    trainer.run_epoch(0, "Train")
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - ctx["t0"]

    stream.limit = None
    t_start = time.perf_counter()
    stream.deadline = t_start + ctx["seconds"]
    trainer.run_epoch(0, "Train")
    window = time.perf_counter() - t_start
    ctx["mark"]("window over")
    timing = dict(trainer.last_epoch_timing)
    steps = timing["steps"]
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0

    summary, rows = None, []
    if ctx["trace"]:
        stream.deadline = None
        stream.limit = mix["trace_steps"]
        stream.on_batch = lambda epoch, b: rows.append(k3_rows(
            b["train_label"], n_classes, con["max_pixels_per_class"]))
        tracer = Tracer()
        tracer.start()
        trainer.run_epoch(0, "Train")
        tracer.stop()
        summary = tracer.summary()
        each = 1e3 * summary["wall_s"] / mix["trace_steps"]
        print(f"traced slice: {each:.3f} ms a step; window: "
              f"{1e3 * window / max(steps, 1):.3f} ms a step", flush=True)

    del trainer, state, model, stream, pipe
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = train_numbers(prog, reference_steps(
        ref, theta0, memory0, catalog, checked, cfg, mix, seed, dev))

    scans = steps * bsz
    return {
        "setup_s": setup_s,
        "attempted": scans, "failed": 0,
        "metrics": {"train_scans_per_s": scans / window, "setup_s": setup_s},
        "samples": steps,
        "peak": peak,
        "numbers": numbers,
        "trace": summary,
        "layer_ctx": {
            "kind": "train", "cfg": cfg, "mix": mix,
            "scans_per_s": scans / window, "timing": timing,
            "k3_rows": rows,
        },
    }


def hyper(cfg: dict, mix: dict) -> dict:
    """What the reference step takes from the configuration and the mix."""
    from benchmark.reference import train as rt

    con, tr = cfg["contrast"], cfg["train"]
    spe = mix["epoch_scans"] // mix["batch"]
    ratio = 0.5 * np.log(1 + 1 / tr["n_epochs"]) / np.log(2)
    return {"batch": mix["batch"], "num_anchor": con["num_anchor"],
            "m_budget": con["max_pixels_per_class"],
            "momentum": con["proto_momentum"],
            "temperature": con["temperature"],
            "base_temperature": con["base_temperature"],
            "w_contrast": con["loss_w_contrast"], "ratio": float(ratio),
            "lr": tr["lr"], "warmup_steps": tr["warmup_epochs"] * spe,
            "total_steps": tr["n_epochs"] * spe,
            "img_mean": cfg["sensor"]["img_mean"],
            "img_stds": cfg["sensor"]["img_stds"],
            "alpha": rt.focal_alpha(cfg["data"]["cls_counts"])}


def reference_steps(ref, theta0, memory0, catalog, fed, cfg, mix, seed, dev,
                    fp8: bool = False, keep_batch: int | None = None,
                    unchanged: bool = False) -> dict:
    """The plain reference's first steps on the scans the program was fed:
    its readings in the form :func:`benchmark.check.train_numbers` takes.
    ``fp8``, ``keep_batch`` and ``unchanged`` (each step returns the
    state it was given: no update, an optimizer that holds nothing, the
    memory as it started) put a lower precision or a fault in place, for
    the control."""
    import torch

    from benchmark.reference import data as rd
    from benchmark.reference import models as rm
    from benchmark.reference import train as rt

    ref = ref.to(dev)
    with torch.no_grad():
        for n, p in ref.named_parameters():
            p.copy_(theta0[n])
    rm.set_fp8(ref, fp8)
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    opt = rt.AdamW(ref.parameters(), wd=cfg["train"]["weight_decay"])
    hp = hyper(cfg, mix)
    memory = memory0.clone()
    out = {"losses": []}
    for s, (epoch, idx) in enumerate(fed[:CHECKED_STEPS]):
        host = rd.batch(catalog, cfg["sensor"], cfg["data"]["max_points"],
                        cfg["augment"], seed, epoch, idx)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        if unchanged:
            saved = {n: p.detach().clone() for n, p in ref.named_parameters()}
        loss, new, grads = rt.step(ref, opt, memory, batch, gen, hp, s,
                                   keep_batch=keep_batch)
        if unchanged:
            with torch.no_grad():
                for n, p in ref.named_parameters():
                    p.copy_(saved[n])
            grads = {n: torch.zeros_like(g) for n, g in grads.items()}
        else:
            memory = new
        out["losses"].append(loss["total"])
        if s == 0:
            out["grad"] = _norms(grads.items())
    out["change"] = _norms((n, p.detach() - theta0[n])
                           for n, p in ref.named_parameters())
    out["memory"] = memory
    out["memory0"] = rt.l2n(memory0)
    rm.set_fp8(ref, False)
    return out
