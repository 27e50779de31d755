"""Data parallelism across GPUs: the process group, the batch stripe, the
replicated state, and the collectives of the training step.

Port of the JAX package's ``parallel/mesh.py``. There, data parallelism is
one sharded program: the batch is sharded on a ``data`` axis, the state is
replicated, and the gradient mean, the BatchNorm statistics, the prototype
contraction and the confusion sum all reduce over the *global* batch with
no collective in user code. Here each GPU is its own process (launched by
``torchrun``), and the same global-batch results come from explicit
``torch.distributed`` collectives:

- NCCL on ``cuda``, gloo on ``cpu``; gloo also takes CUDA tensors, which
  is how two ranks share one card (NCCL refuses two ranks on one device).
  A backend that does not fit the device raises; nothing falls back.
- :func:`shard_batch` puts the rank's stripe on its device (the pipeline
  stripes scans by ``process_index`` / ``process_count``, so the global
  batch is the ranks' stripes concatenated in rank order);
  :func:`replicate_to_mesh` broadcasts rank 0's state, the generator the
  step draws its noise from included, and hands the mesh to the modules
  that reduce over the global batch (``models/blocks.py``: BatchNorm and
  dropout).
- :func:`all_reduce_sum` and :func:`all_gather` are differentiable: the
  backward of a sum over ranks is the sum of the ranks' gradients, so the
  convention of the training step (each rank's loss is its share of the
  global loss; gradients are summed) gives the global gradient.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel group (the default
    process group): its rank, the world size and its device."""
    rank: int
    world: int
    device: torch.device

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def _check_backend(backend: str, device: torch.device) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: use one of "
                         f"{BACKENDS}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"backend 'nccl' needs a CUDA device, got "
                         f"{device}; use 'gloo' on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")


def make_mesh(device: str | torch.device = "cuda", backend: str | None = None,
              *, init_method: str | None = None, rank: int | None = None,
              world_size: int | None = None) -> Mesh:
    """Join the default process group (starting it if needed) and return
    this rank's :class:`Mesh`.

    With no ``init_method`` the group comes from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``), and ``device="cuda"`` means the card of
    ``LOCAL_RANK``. The explicit form (``init_method="tcp://localhost:PORT"``
    with ``rank`` and ``world_size``) serves tests and in-process runs; its
    ``device`` is taken as given (``"cuda"``: the current card). ``backend`` defaults to the running
    group's, else to NCCL on a card and gloo on the CPU.
    """
    from coarse3d_tpu_torch.device import resolve_device

    if init_method is None:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing and not dist.is_initialized():
            raise RuntimeError(
                f"no process group: {', '.join(missing)} not set. Launch "
                f"with torchrun --nproc_per_node=N, or pass init_method, "
                f"rank and world_size")
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    else:
        if rank is None or world_size is None:
            raise ValueError("init_method needs rank and world_size")
        dev = torch.device(device)
    dev = resolve_device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if backend is None:
        backend = (dist.get_backend() if dist.is_initialized()
                   else "nccl" if dev.type == "cuda" else "gloo")
    _check_backend(backend, dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()!r}"
                             f", not {backend!r}")
    elif init_method is None:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size)
    return Mesh(rank=dist.get_rank(), world=dist.get_world_size(), device=dev)


def destroy_mesh() -> None:
    """Leave the default process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def shard_batch(batch: dict[str, Any], mesh: Mesh) -> dict[str, torch.Tensor]:
    """The rank's stripe of the global batch (the pipeline's batch dict,
    numpy or tensors) as tensors on the rank's device."""
    return {k: torch.as_tensor(v).to(mesh.device, non_blocking=True)
            for k, v in batch.items()}


@torch.no_grad()
def replicate_to_mesh(state, mesh: Mesh):
    """Make every rank hold rank 0's training state, and set ``mesh`` on
    the model's modules that reduce over the global batch.

    Broadcast from rank 0: the model's parameters and buffers, the
    prototype memory and the state of the generator the step draws its
    noise and dropout masks from, so that the ranks' draws stay identical
    (``train/step.py`` slices them). The step counter and the optimizer's
    moments are not broadcast: every rank builds its state from the same
    seed and restores the same checkpoint (``build_state``, as the JAX
    package's ``replicate_to_mesh`` assumes).
    """
    if mesh.world > 1:
        for t in list(state.model.state_dict().values()) + [state.prototypes]:
            dist.broadcast(t, src=0)
        gen = state.generator.get_state().to(mesh.device)
        dist.broadcast(gen, src=0)
        state.generator.set_state(gen.cpu())
    attach_mesh(state.model, mesh)
    return state


def attach_mesh(model: torch.nn.Module, mesh: Mesh | None) -> None:
    """Set ``mesh`` on every module of ``model`` that reduces over the
    global batch (``models/blocks.py``: ``BatchNorm2d``, ``Dropout2d``);
    None makes them local again."""
    for mod in model.modules():
        if hasattr(mod, "mesh"):
            mod.mesh = mesh


# -- collectives ------------------------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rank, world):
        ctx.rank, ctx.n = rank, x.shape[0]
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n], None, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The sum over ranks of ``x`` (a new tensor; ``x`` itself without a
    mesh or at world size 1), with the backward of a sum: each rank's input
    gets the sum of every rank's output gradient."""
    if mesh is None or mesh.world == 1:
        return x
    return _AllReduceSum.apply(x)


def all_gather(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along dim 0 in rank
    order, with the backward of a gather: each rank's input gets the sum
    over ranks of the gradient of its own rows."""
    if mesh is None or mesh.world == 1:
        return x
    if x.dtype == torch.bool:               # gloo gathers no bool
        return all_gather(x.to(torch.uint8), mesh).bool()
    return _AllGather.apply(x, mesh.rank, mesh.world)


def stripe(x: torch.Tensor, mesh: Mesh | None, dim: int = 0) -> torch.Tensor:
    """The rank's equal share of ``x`` along ``dim`` (the global noise of a
    step, drawn alike on every rank)."""
    if mesh is None or mesh.world == 1:
        return x
    n = x.shape[dim] // mesh.world
    return x.narrow(dim, mesh.rank * n, n)
