"""Top-level entry points of the port: a one-card forward and a multi-process
dry run of training.

The analog of the JAX package's repo-level ``__graft_entry__.py``:

- :func:`entry` gives ``(fn, example_args)``: the SalsaNext forward of the
  ``kitti`` preset (64x2048, 20 classes, bf16 autocast inside the model,
  seeded random weights), features in the JAX layout (1, H, W, 5) in,
  ``probs`` (1, H, W, C) out.
- :func:`dryrun_multichip` runs ``n`` processes through ``parallel/mesh.py``
  at the JAX dry run's tiny configuration and checks what that one checks:
  the full contrast step (finite loss, confusion counts), the reference's
  per-rank prototype update (``update_prototypes_ddp_parity``, a non-zero
  memory) and the KNN eval step (its global confusion counts, its
  ``argmax_2d`` has the labels' shape). The JAX dry run forces a virtual
  CPU mesh; this one runs on the device it is given: NCCL when every rank
  has a card of its own, gloo otherwise (the CPU, or ranks sharing a card,
  which NCCL refuses), as ``parallel/mesh.py`` allows.

  python -m coarse3d_tpu_torch.entry                  # forward on the card
  python -m coarse3d_tpu_torch.entry multichip 2 [cpu]
"""

from __future__ import annotations

import os
import socket
import sys
import tempfile

import numpy as np
import torch


def entry(device: str | torch.device = "cuda"):
    """(fn, example_args): the forward of the flagship model, SalsaNext on
    the SemanticKITTI 64x2048 spec, bf16 compute. ``fn(features)`` takes
    (B, H, W, 5) float32 features and returns (B, H, W, C) probabilities;
    ``fn.model`` is the module, for loading weights into."""
    from coarse3d_tpu_torch.configs import preset
    from coarse3d_tpu_torch.train.setup import build_model

    cfg = preset("kitti")
    model = build_model(cfg, device=device, seed=0)
    x = torch.zeros(
        (1, cfg.sensor.proj_h, cfg.sensor.proj_w, cfg.model.in_channels),
        dtype=torch.float32, device=next(model.parameters()).device)

    @torch.inference_mode()
    def forward(features: torch.Tensor) -> torch.Tensor:
        out = model(features.permute(0, 3, 1, 2).contiguous(),
                    return_feat=False)
        return out["probs"].permute(0, 2, 3, 1)

    forward.model = model
    return forward, (x,)


def _dryrun_config():
    """The JAX dry run's configuration (``__graft_entry__.py``): 16x64
    images, 8 classes, full-width SalsaNext in bf16, a small memory."""
    from coarse3d_tpu_torch.configs.config import (
        ContrastConfig,
        DataConfig,
        ExperimentConfig,
        ModelConfig,
        SensorSpec,
    )

    return ExperimentConfig(
        data=DataConfig(dataset="synthetic", n_classes=8, max_points=2048,
                        cls_counts=tuple([0.0] + [100.0] * 7)),
        sensor=SensorSpec(proj_h=16, proj_w=64),
        model=ModelConfig(compute_dtype="bfloat16"),
        contrast=ContrastConfig(
            num_anchor=32, max_pixels_per_class=128, sub_proto_size=4,
            proj_dim=32),
    )


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dryrun_rank(rank: int, n: int, device: str, backend: str, port: int,
                 out_dir: str) -> None:
    """One rank of :func:`dryrun_multichip`: the three programs on its
    stripe of the global batch (one scan a rank); its results go to
    ``out_dir``/rank<r>.pt."""
    from coarse3d_tpu_torch.data.synthetic import synthetic_batch
    from coarse3d_tpu_torch.models.prototypes import (
        update_prototypes_ddp_parity,
    )
    from coarse3d_tpu_torch.ops import knn_vote, proj_scatter, proto_update
    from coarse3d_tpu_torch.parallel import destroy_mesh, make_mesh
    from coarse3d_tpu_torch.parallel.mesh import (
        all_reduce_sum,
        replicate_to_mesh,
        shard_batch,
    )
    from coarse3d_tpu_torch.train.setup import build_alpha, build_state
    from coarse3d_tpu_torch.train.step import (
        draw_noise,
        make_eval_step,
        make_train_step,
    )

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    mesh = make_mesh(dev, backend, init_method=f"tcp://localhost:{port}",
                     rank=rank, world_size=n)
    try:
        cfg = _dryrun_config()
        rng = np.random.default_rng(0)
        host = synthetic_batch(rng, cfg, batch_size=n, n_points=1500,
                               weak_ratio=0.01)
        batch = shard_batch({k: v[rank:rank + 1] for k, v in host.items()},
                            mesh)
        state = replicate_to_mesh(
            build_state(cfg, device=mesh.device, seed=0, steps_per_epoch=10),
            mesh)
        step = make_train_step(cfg, build_alpha(cfg), with_contrast=True,
                               mesh=mesh)
        state, metrics = step(state, batch, 0.25)
        out = {"total": float(metrics["losses"]["total"]),
               "conf": int(metrics["confusion"].sum())}

        # the reference's DDP prototype path: each rank's own update on its
        # stripe with its own Gumbel, then the mean over ranks
        emb = rng.normal(size=(n, 16, 64, cfg.contrast.proj_dim))
        emb = torch.as_tensor(emb[rank:rank + 1], dtype=torch.float32,
                              device=mesh.device)
        gen = torch.Generator(device=mesh.device).manual_seed(1 + rank)
        gumbel = draw_noise(gen, cfg, 1, 16, 64)["proto"]
        label = batch["train_label"].to(torch.int32)
        protos = update_prototypes_ddp_parity(
            state.prototypes, emb, label, label > 0, gumbel, cfg.contrast,
            mesh)
        out["pnorm"] = float(torch.linalg.norm(protos))

        # the evaluate CLI's path: forward, KNN, unprojection, confusion
        # summed over ranks
        eval_out = make_eval_step(cfg, use_knn=True)(state, batch)
        out["eval_conf"] = int(all_reduce_sum(eval_out["confusion"],
                                              mesh).sum())
        out["argmax_shape"] = tuple(eval_out["argmax_2d"].shape)
        out["label_shape"] = tuple(batch["train_label"].shape)
        out["launches"] = {
            "proj_scatter_min": (proj_scatter.project_scatter.launches
                                 + proj_scatter.scatter_min.launches),
            "knn_vote": knn_vote.knn_vote.launches,
            "proto_tail": proto_update.proto_tail.launches}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        destroy_mesh()


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda"
                     ) -> dict:
    """Run the full training step (contrast + prototype EMA), the
    reference-parity prototype path and the KNN eval step over
    ``n_devices`` processes at tiny shapes, one scan a rank; assert what
    the JAX dry run asserts and print its line. Returns rank 0's results,
    with the kernels' launches summed over the ranks."""
    import torch.multiprocessing as mp

    from coarse3d_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    own_cards = (dev.type == "cuda"
                 and n_devices <= torch.cuda.device_count())
    backend = "nccl" if own_cards else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_dryrun_rank,
                 args=(n_devices, dev.type, backend, _free_port(), tmp),
                 nprocs=n_devices, join=True)
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                 for r in range(n_devices)]
    res = dict(ranks[0])
    res["launches"] = {k: sum(r["launches"][k] for r in ranks)
                       for k in res["launches"]}
    res["backend"] = backend
    checks = {
        # every result is reduced over the ranks, so all hold the same
        "the ranks agree": all(r[k] == res[k] for r in ranks
                               for k in ("total", "conf", "pnorm",
                                         "eval_conf")),
        "finite loss": np.isfinite(res["total"]),
        "confusion counts": res["conf"] > 0,
        "non-zero memory": np.isfinite(res["pnorm"]) and res["pnorm"] > 0,
        "eval confusion counts": res["eval_conf"] > 0,
        "argmax_2d has the labels' shape": (res["argmax_shape"]
                                            == res["label_shape"]),
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"dryrun_multichip({n_devices}) failed: "
                           f"{failed}; rank results {ranks}")
    print(f"dryrun_multichip({n_devices}): total_loss={res['total']:.4f} "
          f"conf_points={res['conf']} parity_proto_norm={res['pnorm']:.3f} "
          f"eval_conf_points={res['eval_conf']} OK")
    return res


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "multichip":
        dryrun_multichip(int(sys.argv[2]) if len(sys.argv) > 2 else 2,
                         sys.argv[3] if len(sys.argv) > 3 else "cuda")
    else:
        fn, args = entry()
        out = fn(*args)
        print("entry forward:", tuple(out.shape), out.dtype)
