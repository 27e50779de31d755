"""Share of the traced training slice in which nothing ran on the card while
the host was inside the program's span ``train.data`` (train/trainer.py):
the wait for the pipeline's batch and its copy to the card, the interval
of the Trainer's DT."""

NAME = "idle_data_pct.train"
UNIT = "%"
LAYER = "data"
SOURCE = "program_span"
MOVES = "train_scans_per_s"


def read(ctx):
    from benchmark import spans

    return spans.idle_pct(ctx, "train.data")
