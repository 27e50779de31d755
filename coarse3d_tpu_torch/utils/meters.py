"""Progress meters, the port's copy of the JAX package's ``utils/meters.py``
(reference: utils/avgmeter.py:1-40, remain_time.py:4-36)."""

from __future__ import annotations


class AverageMeter:
    """Running mean of a scalar stream."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class RunningAvgMeter:
    """Exponential moving average (reference alpha 0.95)."""

    def __init__(self, alpha: float = 0.95):
        self.alpha = alpha
        self.reset()

    def reset(self):
        self.avg = 0.0
        self._initialized = False

    def update(self, val: float):
        if not self._initialized:
            self.avg = val
            self._initialized = True
        else:
            self.avg = self.alpha * self.avg + (1 - self.alpha) * val


class RemainTime:
    """ETA estimator: EMA of per-iteration cost per mode, extrapolated over
    remaining iterations of all epochs."""

    def __init__(self, n_epochs: int):
        self.n_epochs = n_epochs
        self.meters: dict[str, RunningAvgMeter] = {}
        self.totals: dict[str, int] = {}

    def update(self, cost_time: float, mode: str = "Train"):
        self.meters.setdefault(mode, RunningAvgMeter()).update(cost_time)

    def get_remain_time(self, epoch: int, iters: int, total_iter: int,
                        mode: str = "Train") -> float:
        self.totals[mode] = total_iter
        remain = 0.0
        for m, meter in self.meters.items():
            total = self.totals.get(m, total_iter)
            remain_iters = (self.n_epochs - epoch - 1) * total
            if m == mode:
                remain_iters += total_iter - iters - 1
            remain += meter.avg * remain_iters
        return max(remain, 0.0)
