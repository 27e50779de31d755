"""Mean host milliseconds the run loop spent enqueueing a step of the
window: the Trainer's own PT (train/trainer.py,
``last_epoch_timing["proc_s"]``)."""

NAME = "host_step_ms.train"
UNIT = "ms"
LAYER = "run loop"
SOURCE = "program_span"
MOVES = "train_scans_per_s"


def read(ctx):
    timing = ctx.get("timing")
    if not timing or not timing.get("steps"):
        return None
    return 1e3 * timing["proc_s"]
