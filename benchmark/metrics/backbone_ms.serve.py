"""Mean device milliseconds a served batch spends between the stream markers
of the program's span ``serve.backbone`` (eval/inference.py): the model's
forward and the argmax over its logits."""

NAME = "backbone_ms.serve"
UNIT = "ms"
LAYER = "model step"
SOURCE = "program_span"
MOVES = "serve_scans_per_s"


def read(ctx):
    from benchmark import spans

    return spans.device_ms(ctx, "serve.backbone")
