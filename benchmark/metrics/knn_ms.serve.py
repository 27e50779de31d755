"""Mean device milliseconds a served batch spends between the stream markers
of the program's span ``serve.knn`` (eval/inference.py): the KNN
post-processing with K2 and the labels it gives each point."""

NAME = "knn_ms.serve"
UNIT = "ms"
LAYER = "KNN"
SOURCE = "program_span"
MOVES = "serve_scans_per_s"


def read(ctx):
    from benchmark import spans

    return spans.device_ms(ctx, "serve.knn")
