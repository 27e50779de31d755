"""Share of the traced serving slice in which nothing ran on the card while
the host was inside no span of the program: the caller's own work between
batches (its copy of the labels to the host, its loop)."""

NAME = "idle_outside_pct.serve"
UNIT = "%"
LAYER = "serving entry"
SOURCE = "program_span"
MOVES = "serve_scans_per_s"


def read(ctx):
    from benchmark import spans

    return spans.idle_pct(ctx, None)
