"""Mean host milliseconds a step of the window waited for its batch and
its copy to the card: the Trainer's own DT (train/trainer.py,
``last_epoch_timing["data_s"]``)."""

NAME = "data_wait_ms.train"
UNIT = "ms"
LAYER = "data"
SOURCE = "program_span"
MOVES = "train_scans_per_s"


def read(ctx):
    timing = ctx.get("timing")
    if not timing or not timing.get("steps"):
        return None
    return 1e3 * timing["data_s"]
