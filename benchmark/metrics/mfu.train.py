"""The window's trained scans a second times three forward passes with
the contrastive projector (forward and backward; recomputation is not
counted), as a share of the card's bf16 dense peak."""

NAME = "mfu.train"
UNIT = "%"
LAYER = "model step"
SOURCE = "host_clock"
MOVES = "train_scans_per_s"


def read(ctx):
    from benchmark.roofline import flops, peaks

    if ctx.get("kind") != "train":
        return None
    return 100.0 * 3 * flops.forward_flops(ctx["cfg"], return_feat=True) * (
        ctx["scans_per_s"]) / peaks.BF16_FLOPS
