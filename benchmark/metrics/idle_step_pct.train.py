"""Share of the traced training slice in which nothing ran on the card while
the host was inside the program's span ``train.step`` but outside
``train.data`` (train/trainer.py): the card waiting on the step's own
Python."""

NAME = "idle_step_pct.train"
UNIT = "%"
LAYER = "run loop"
SOURCE = "program_span"
MOVES = "train_scans_per_s"


def read(ctx):
    from benchmark import spans

    return spans.idle_pct(ctx, "train.step", outside="train.data")
