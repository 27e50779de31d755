"""K2, the KNN vote (coarse3d_tpu_torch/ops/knn_vote.py): the least time
its bytes and float32 operations need at the card's peaks over its device
time a launch in the traced slice (its four kernels, by name)."""

NAME = "k2_roofline"
UNIT = "%"
LAYER = "KNN"
SOURCE = "device_trace"
MOVES = "serve_scans_per_s"
KERNELS = ("tile_count", "tile_scan", "tile_scatter", "tile_vote")


def read(ctx):
    from benchmark.roofline import kernels
    from benchmark.trace import kernel_time

    t = ctx.get("trace")
    if not t or "k2" not in ctx:
        return None
    seconds, launches = kernel_time(t, KERNELS, "tile_vote")
    if not launches or seconds <= 0:
        return None
    k = ctx["k2"]
    bound, _ = kernels.bound_s(*kernels.k2_knn_vote(
        k["b"], k["p"], k["hw"], k["knn"], k["search"]))
    return 100.0 * bound * launches / seconds
