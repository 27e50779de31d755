"""K1, the fused projection (coarse3d_tpu_torch/ops/proj_scatter.py):
the least time its bytes need at the card's HBM bandwidth over its device
time a launch in the traced slice (its two kernels, by name; the memset
before them is not counted). Bound by bytes."""

NAME = "k1_roofline"
UNIT = "%"
LAYER = "projection"
SOURCE = "device_trace"
MOVES = "serve_scans_per_s"
KERNELS = ("scatter_keys", "emit_pixels")


def read(ctx):
    from benchmark.roofline import kernels
    from benchmark.trace import kernel_time

    t = ctx.get("trace")
    if not t or "k1" not in ctx:
        return None
    seconds, launches = kernel_time(t, KERNELS, "emit_pixels")
    if not launches or seconds <= 0:
        return None
    k = ctx["k1"]
    bound, _ = kernels.bound_s(*kernels.k1_projection(k["b"], k["p"], k["c"],
                                                      k["hw"]))
    return 100.0 * bound * launches / seconds
