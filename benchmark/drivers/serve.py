"""Offline labelling: one client in a closed loop hands the program's
``eval/inference.py:make_inference_fn`` batches of padded scans, as
``tools/infer.py`` does, and copies each batch's labels to the host before
it sends the next.

The mix file gives ``batch`` (scans a batch), ``pool_batches`` (batches
made in set-up; the window cycles through them in an order drawn from the
seed), the points a scan (``points_min`` to ``points_max``, padded to the
configuration's ``max_points``), their ``angular`` layout, the
``warmup_batches`` and ``trace_batches``.

The weights are drawn on the card from the seed; BatchNorm's statistics
are then those of two calibration scans and its gains are damped, as a
trained network's smoother maps are (a random network with calibrated
statistics flips labels far from any change). The reference model holds
those weights and gives the program its copy.

Once the window has closed, the labels of one served occurrence of each
pool batch, drawn from the seed, are held against the float32 reference
(:func:`mismatch_numbers`).
"""

from __future__ import annotations

import time

import numpy as np

MIN_FP8_MISMATCH = 0.01


def _calibrate(ref, scans, cfg, dev, gain):
    """BatchNorm statistics from one training-mode pass without dropout,
    then gains damped."""
    import torch

    from benchmark import generate
    from benchmark.reference import models as rm
    from benchmark.reference import serve as rs

    p = cfg["data"]["max_points"]
    pts, val = zip(*(generate.pad_points(s["points"], p) for s in scans))
    pts = torch.from_numpy(np.stack(pts)).to(dev)
    val = torch.from_numpy(np.stack(val)).to(dev)
    proj = rs.project(pts, val, cfg["sensor"])
    x = rs.normalize(proj["features"], proj["hit"], cfg["sensor"])
    bns = [m for m in ref.modules() if isinstance(m, rm.BatchNorm2d)]
    saved = [m.momentum for m in bns]
    ref.train()
    for m in ref.modules():
        if isinstance(m, rm.Dropout2d):
            m.eval()
    for m in bns:
        m.momentum = 1.0
    with torch.no_grad():
        ref(x.permute(0, 3, 1, 2).contiguous())
        for m, mom in zip(bns, saved):
            m.momentum = mom
            m.weight.mul_(gain)
    ref.eval()


def make_pool(seed: int, cfg: dict, mix: dict) -> list:
    """The window's batches: (points (B, P, 4), valid (B, P)) pairs."""
    from benchmark import generate

    bsz, pmax = mix["batch"], cfg["data"]["max_points"]
    raw = generate.scans(seed, 0, mix["pool_batches"] * bsz, mix, cfg)
    pool = []
    for i in range(mix["pool_batches"]):
        padded = [generate.pad_points(s["points"], pmax)
                  for s in raw[i * bsz:(i + 1) * bsz]]
        pool.append((np.stack([a for a, _ in padded]),
                     np.stack([v for _, v in padded])))
    return pool


def make_reference(seed: int, cfg: dict, mix: dict, dev):
    """The reference model on ``dev`` with the cell's weights: drawn from
    the seed, BatchNorm calibrated, gains damped."""
    from benchmark import generate, harness
    from benchmark.reference import models as rm

    ref = rm.build(cfg["model"], cfg["data"]["n_classes"],
                   cfg["contrast"]["proj_dim"]).to(dev)
    harness.make_weights(ref, seed, dev)
    _calibrate(ref, generate.scans(seed, 1, mix["calibration_scans"], mix,
                                   cfg), cfg, dev, harness.BN_GAIN)
    return ref


def reference_labels(ref, pool_batch, cfg: dict, dev):
    """The reference's labels of one pool batch, on the host."""
    import torch

    from benchmark.reference import serve as rs

    pts, val = pool_batch
    knn = {k: cfg["knn"][k] for k in ("knn", "search", "sigma", "cutoff")}
    return rs.labels(ref, torch.from_numpy(pts).to(dev),
                     torch.from_numpy(val).to(dev), cfg["sensor"],
                     cfg["data"]["n_classes"], knn).cpu()


def mismatch(got, want, valid):
    """Per scan of a batch: valid points whose labels differ, and valid
    points (two int64 tensors of the batch's length)."""
    import torch

    v = torch.from_numpy(valid)
    return ((got != want) & v).sum(dim=1), v.sum(dim=1)


def mismatch_numbers(got: dict, want: dict, low: dict, pool: list) -> dict:
    """``label_mismatch``: the share of valid points whose served label
    differs from the float32 reference's; ``fp8_mismatch``: the same share
    for the reference with float8 convolutions; ``label_mismatch_rel``:
    the first over the second (at least 1 %). How many labels rounding
    flips depends on how sensitive a seed's random network is, which
    differs from seed to seed several times over; the ratio to float8's
    flips on the same scans and weights does not.

    ``scan_mismatch_rel_max`` is that ratio scan by scan, the largest over
    the checked scans, so that one slot of a batch served wrong cannot hide
    in the batch's total; ``scan_mismatch_max`` is the largest share of a
    scan alone."""
    bad = low_bad = total = 0
    worst_rel = worst = 0.0
    for pi in got:
        b, t = mismatch(got[pi], want[pi], pool[pi][1])
        lb, _ = mismatch(low[pi], want[pi], pool[pi][1])
        bad += int(b.sum())
        low_bad += int(lb.sum())
        total += int(t.sum())
        share = b.double() / t.clamp(min=1)
        low_share = lb.double() / t.clamp(min=1)
        worst = max(worst, float(share.max()))
        worst_rel = max(worst_rel, float(
            (share / low_share.clamp(min=MIN_FP8_MISMATCH)).max()))
    raw, fp8 = bad / max(total, 1), low_bad / max(total, 1)
    return {"label_mismatch": raw, "fp8_mismatch": fp8,
            "label_mismatch_rel": raw / max(fp8, MIN_FP8_MISMATCH),
            "scan_mismatch_max": worst,
            "scan_mismatch_rel_max": worst_rel}


def run(ctx: dict) -> dict:
    import torch

    from benchmark import harness
    from benchmark.reference import models as rm
    from benchmark.trace import Tracer
    from coarse3d_tpu_torch.eval.inference import make_inference_fn
    from coarse3d_tpu_torch.train.setup import build_model

    cfg, mix, seed = ctx["cfg"], ctx["mix"], ctx["seed"]
    dev = torch.device(ctx["device"])
    rm.float32_math()
    sensor = cfg["sensor"]
    bsz, pmax = mix["batch"], cfg["data"]["max_points"]

    ctx["mark"]("imports done")
    pool = make_pool(seed, cfg, mix)
    ctx["mark"]("scans made")
    ref = make_reference(seed, cfg, mix, dev)
    ctx["mark"]("weights made and calibrated")

    pcfg = harness.program_config(cfg, seed)
    model = build_model(pcfg, device=dev)
    model.load_state_dict(ref.state_dict())
    ref.cpu()
    infer = ctx.get("make_inference_fn", make_inference_fn)(model, pcfg)

    order_rng = np.random.default_rng((seed, 2))

    def pool_order():
        while True:
            yield from order_rng.permutation(mix["pool_batches"]).tolist()

    def serve(pi):
        pts, val = pool[pi]
        return infer(torch.from_numpy(pts), torch.from_numpy(val)).cpu()

    ctx["mark"]("program built")
    for pi in range(mix["warmup_batches"]):
        serve(pi % mix["pool_batches"])
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - ctx["t0"]

    # one kept output per pool batch: a reservoir over its occurrences
    keep_rng = np.random.default_rng((seed, 3))
    kept, seen = {}, {}
    lat = []
    order = pool_order()
    t_start = time.perf_counter()
    deadline = t_start + ctx["seconds"]
    t_end = t_start
    while t_end < deadline:
        pi = next(order)
        t = time.perf_counter()
        labels = serve(pi)
        t_end = time.perf_counter()
        lat.append(t_end - t)
        seen[pi] = seen.get(pi, 0) + 1
        if keep_rng.random() * seen[pi] < 1.0:
            kept[pi] = labels
    window = t_end - t_start
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    served = len(lat) * bsz

    summary = None
    if ctx["trace"]:
        tracer = Tracer()
        tracer.start()
        for _ in range(mix["trace_batches"]):
            serve(next(order))
        tracer.stop()
        summary = tracer.summary()
        each = 1e3 * summary["wall_s"] / mix["trace_batches"]
        print(f"traced slice: {each:.3f} ms a batch; window: "
              f"{1e3 * window / len(lat):.3f} ms a batch", flush=True)

    del infer, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref.to(dev).eval()
    want = {pi: reference_labels(ref, pool[pi], cfg, dev) for pi in kept}
    rm.set_fp8(ref, True)
    low = {pi: reference_labels(ref, pool[pi], cfg, dev) for pi in kept}
    numbers = mismatch_numbers(kept, want, low, pool)
    print(f"serve: {len(lat)} batches of {bsz} in {window:.3f} s; "
          f"{len(kept)} pool batches checked", flush=True)

    lat_ms = np.asarray(lat) * 1e3
    return {
        "setup_s": setup_s,
        "attempted": served, "failed": 0,
        "metrics": {"serve_scans_per_s": served / window,
                    "serve_batch_ms_p95": float(np.percentile(lat_ms, 95)),
                    "setup_s": setup_s},
        "samples": len(lat),
        "peak": peak,
        "numbers": numbers,
        "trace": summary,
        "layer_ctx": {
            "kind": "serve", "cfg": cfg, "mix": mix,
            "scans_per_s": served / window,
            "k1": {"b": bsz, "p": pmax, "c": 4,
                   "hw": sensor["proj_h"] * sensor["proj_w"]},
            "k2": {"b": bsz, "p": pmax,
                   "hw": sensor["proj_h"] * sensor["proj_w"],
                   "knn": cfg["knn"]["knn"], "search": cfg["knn"]["search"]},
        },
    }
