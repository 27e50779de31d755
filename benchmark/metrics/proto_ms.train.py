"""Mean device milliseconds a training step spends between the stream
markers of the program's span ``train.prototypes`` (train/step.py): the
memory update with K3 and its diagnostics."""

NAME = "proto_ms.train"
UNIT = "ms"
LAYER = "prototype memory"
SOURCE = "program_span"
MOVES = "train_scans_per_s"


def read(ctx):
    from benchmark import spans

    return spans.device_ms(ctx, "train.prototypes")
