"""Training state: model, optimizer and schedule, prototype memory, step,
and the generator the step draws its noise from.

Port of the JAX package's ``train/state.py``. The JAX ``TrainState`` is an
immutable pytree that the step replaces; here the model and the optimizer
are updated in place (no second copy of the parameters and moments), the
prototype memory is replaced by each update, and ``step`` is a host int.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    prototypes: torch.Tensor    # (n_classes, sub_proto_size, proj_dim) f32
    step: int
    generator: torch.Generator  # on the model's device: the step's noise

    @property
    def device(self) -> torch.device:
        return self.prototypes.device

    def load(self, carried: dict) -> None:
        """Load what ``tools/convert_jax_params.py:train_state_from_jax``
        returns: model state dict, prototypes, step and Adam moments; the
        schedule resumes at ``step``."""
        dev = self.device
        self.model.load_state_dict(carried["model"], strict=True)
        self.prototypes = carried["prototypes"].to(dev, torch.float32)
        self.step = int(carried["step"])
        params = dict(self.model.named_parameters())
        for name, st in carried["optimizer"].items():
            self.optimizer.state[params[name]] = {
                "step": torch.tensor(float(st["step"])),
                "exp_avg": st["exp_avg"].to(dev, torch.float32).clone(),
                "exp_avg_sq": st["exp_avg_sq"].to(dev, torch.float32).clone(),
            }
        self.scheduler.last_epoch = self.step
        for group, lam, base in zip(self.optimizer.param_groups,
                                    self.scheduler.lr_lambdas,
                                    self.scheduler.base_lrs):
            group["lr"] = base * lam(self.step)


def init_prototypes(generator: torch.Generator, n_classes: int,
                    sub_proto_size: int, proj_dim: int) -> torch.Tensor:
    """Truncated-normal(±2) x 0.02 memory, as trunc_normal_ at
    salsanext_proto.py:325; drawn on the CPU from ``generator``."""
    protos = torch.empty(n_classes, sub_proto_size, proj_dim)
    torch.nn.init.trunc_normal_(protos, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=generator)
    return protos * 0.02
