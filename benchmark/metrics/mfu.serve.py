"""The window's served scans a second times one scan's forward FLOPs
(counted on the frozen reference model, benchmark/roofline/flops.py),
as a share of the card's bf16 dense peak."""

NAME = "mfu.serve"
UNIT = "%"
LAYER = "model step"
SOURCE = "host_clock"
MOVES = "serve_scans_per_s"


def read(ctx):
    from benchmark.roofline import flops, peaks

    if ctx.get("kind") != "serve":
        return None
    return 100.0 * flops.forward_flops(ctx["cfg"]) * ctx["scans_per_s"] / (
        peaks.BF16_FLOPS)
