"""Share of the traced serving slice in which nothing ran on the card while
the host was inside the program's span ``serve.copy_in``
(eval/inference.py): the points and their mask copied to the card."""

NAME = "idle_copy_pct.serve"
UNIT = "%"
LAYER = "serving entry"
SOURCE = "program_span"
MOVES = "serve_scans_per_s"


def read(ctx):
    from benchmark import spans

    return spans.idle_pct(ctx, "serve.copy_in")
