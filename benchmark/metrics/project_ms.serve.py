"""Mean device milliseconds a served batch spends between the stream markers
of the program's span ``serve.project`` (eval/inference.py): the
projection with K1, the range features and their normalisation, whatever
their kernels are named."""

NAME = "project_ms.serve"
UNIT = "ms"
LAYER = "projection"
SOURCE = "program_span"
MOVES = "serve_scans_per_s"


def read(ctx):
    from benchmark import spans

    return spans.device_ms(ctx, "serve.project")
