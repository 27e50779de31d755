"""K3, the prototype update (coarse3d_tpu_torch/ops/proto_update.py): the
least time the traced steps' valid class rows need (float32 operations at
67 TFLOP/s or bytes at the HBM bandwidth, whichever is longer) over the
device time of its three kernels, by name, in the traced slice."""

NAME = "k3_roofline"
UNIT = "%"
LAYER = "prototype memory"
SOURCE = "device_trace"
MOVES = "train_scans_per_s"
KERNELS = ("live_tiles", "row_pass", "class_pass")


def read(ctx):
    from benchmark.roofline import kernels
    from benchmark.trace import kernel_time

    t = ctx.get("trace")
    rows = ctx.get("k3_rows")
    if not t or not rows:
        return None
    seconds, launches = kernel_time(t, KERNELS, "class_pass")
    if not launches or seconds <= 0:
        return None
    con = ctx["cfg"]["contrast"]
    c = ctx["cfg"]["data"]["n_classes"]
    bounds = [kernels.bound_s(*kernels.k3_prototypes(
        r, c, con["max_pixels_per_class"], con["sub_proto_size"],
        con["proj_dim"]))[0] for r in rows]
    return 100.0 * (sum(bounds) / len(bounds)) * launches / seconds
