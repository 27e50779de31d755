from coarse3d_tpu_torch.utils.meters import AverageMeter, RemainTime, RunningAvgMeter
from coarse3d_tpu_torch.utils.recorder import Recorder

__all__ = ["AverageMeter", "RemainTime", "RunningAvgMeter", "Recorder"]
