"""Share of the traced serving slice in which nothing ran on the card."""

NAME = "idle_pct.serve"
UNIT = "%"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "serve_scans_per_s"


def read(ctx):
    t = ctx.get("trace")
    if not t or t["window_s"] <= 0 or not t["device"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
