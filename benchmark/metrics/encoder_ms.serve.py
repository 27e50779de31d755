"""Mean device milliseconds a served batch spends between the stream markers
of the program's span ``model.encoder`` (models/rangenet.py): the darknet
backbone of RangeNet's forward, inside ``serve.backbone``. Only a RangeNet
cell records it."""

NAME = "encoder_ms.serve"
UNIT = "ms"
LAYER = "model step"
SOURCE = "program_span"
MOVES = "serve_scans_per_s"
WORKLOADS = ["rangenet53-kitti.serve-b8"]


def read(ctx):
    from benchmark import spans

    return spans.device_ms(ctx, "model.encoder")
