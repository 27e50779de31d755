"""Post-hoc training of the CRF compatibility kernel on a frozen checkpoint.

Port of the JAX package's ``tools/train_crf.py``. The reference ships the
locally-connected xyz CRF with a LEARNABLE (C, C) compatibility conv
(postproc/crf.py:96-103) but never wires or trains it; with the untrained
init the refinement measurably hurts (PARITY.md CRF entry). This tool
freezes a trained segmentation checkpoint and fits ONLY the compatibility
matrix by cross-entropy of the CRF-refined probabilities against the weak
training labels, the only supervision the weak-label setting legitimately
has. One process, one device (``--device cpu`` for the CPU); with
``--multihost``, one process per card under ``torchrun``, the batch
sharded as in the JAX tool: each process reads its stripe, the weak-CE is
the global batch's (its denominators summed over ranks) and the kernel's
gradient is summed, so every rank fits the same kernel; rank 0 writes it.

  python -m coarse3d_tpu_torch.tools.train_crf --run_dir RUN \
      --ckpt best_3DIOU --synthetic 64 --synthetic_task hard ... \
      --out RUN/crf_kernel.npz
  python -m coarse3d_tpu_torch.tools.evaluate --run_dir RUN \
      --ckpt best_3DIOU --crf --crf_kernel RUN/crf_kernel.npz ...
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run_dir", required=True)
    p.add_argument("--ckpt", default="best_3DIOU")
    p.add_argument("--preset", default="semantic_kitti")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--batch_size", type=int)
    p.add_argument("--num_workers", type=int, default=2)
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--synthetic_task", choices=("bands", "hard"),
                   default="hard")
    p.add_argument("--synthetic_points", type=int, default=0)
    p.add_argument("--synthetic_seed", type=int, default=0)
    p.add_argument("--synthetic_segments", type=int, default=None)
    p.add_argument("--synthetic_modes", type=int, default=None)
    p.add_argument("--synthetic_noise", type=float, default=None)
    p.add_argument("--synthetic_imbalance", type=float, default=None)
    p.add_argument("--weak", type=float, default=0.0001,
                   help="synthetic weak-label ratio (match the training run)")
    p.add_argument("--class_balance", action="store_true",
                   help="weight the weak-CE fit inversely to per-batch weak-"
                        "label class frequency. Under class imbalance the "
                        "unweighted fit is dominated by common-class labels "
                        "and the learned kernel smooths rare classes away; "
                        "balancing makes every present class contribute "
                        "equally to the kernel objective")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="SECTION.KEY=VALUE")
    p.add_argument("--out", required=True, help="output .npz kernel path")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; fails without a card) or 'cpu'")
    p.add_argument("--multihost", action="store_true",
                   help="one process per card under torchrun: the batch "
                        "is sharded over the processes")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from coarse3d_tpu_torch.configs import apply_overrides, preset
    from coarse3d_tpu_torch.data.pipeline import BATCH_KEYS, DataPipeline
    from coarse3d_tpu_torch.device import resolve_device
    from coarse3d_tpu_torch.parallel import destroy_mesh, make_mesh
    from coarse3d_tpu_torch.parallel.mesh import all_reduce_sum
    from coarse3d_tpu_torch.postproc.crf import crf_refine, init_compat_kernel
    from coarse3d_tpu_torch.train.checkpoint import restore_from_run_dir
    from coarse3d_tpu_torch.train.setup import build_state
    from coarse3d_tpu_torch.train.step import _prepare_inputs, batch_to_device

    mesh = make_mesh(args.device) if args.multihost else None
    device = mesh.device if mesh else resolve_device(args.device)
    rank, world = (mesh.rank, mesh.world) if mesh else (0, 1)
    cfg = preset(args.preset)
    if args.overrides:
        cfg = apply_overrides(cfg, args.overrides)

    if args.synthetic:
        from coarse3d_tpu_torch.data.synthetic import (SyntheticDataset,
                                                       SyntheticHardDataset,
                                                       hard_task_kwargs)

        ds_kw = {}
        if args.synthetic_task == "hard":
            ds_cls = SyntheticHardDataset
            ds_kw.update(hard_task_kwargs(args))
        else:
            ds_cls = SyntheticDataset
        n_pts = args.synthetic_points or min(20000, cfg.data.max_points // 2)
        ds = ds_cls(args.synthetic, n_pts, cfg.data.n_classes, cfg.sensor,
                    weak_ratio=args.weak, seed=args.synthetic_seed, **ds_kw)
    else:
        from coarse3d_tpu_torch.data.datasets import build_dataset

        ds = build_dataset(cfg, "train")

    bs = args.batch_size or cfg.train.batch_size_train
    # train=False: no augmentation: the 64-odd kernel params don't need it
    # and clean projections keep the xyz messages consistent across epochs
    pipe = DataPipeline(ds, cfg, bs, train=False,
                        num_workers=args.num_workers,
                        pin_memory=device.type == "cuda",
                        process_index=rank, process_count=world)
    if len(ds) < world:
        raise ValueError(f"{len(ds)} scans cannot feed {world} processes")
    # every rank takes as many steps as the longest stripe (rank 0's)
    n_steps = -(-(-(-len(ds) // world)) // bs)

    state = build_state(cfg, device=device, seed=0, steps_per_epoch=1)
    state = restore_from_run_dir(state, args.run_dir, args.ckpt)
    model = state.model.eval()

    kernel = init_compat_kernel(cfg.data.n_classes, xyz_coef=0.1).to(
        device).requires_grad_()
    # torch.optim.Adam's defaults are optax.adam's: b 0.9 / 0.999, eps 1e-8
    opt = torch.optim.Adam([kernel], lr=args.lr)

    def loss_fn(k, batch):
        features, train_label, _, wss_mask, eval_mask = _prepare_inputs(
            batch, cfg)
        with torch.no_grad():
            logits = model(features.permute(0, 3, 1, 2).contiguous(),
                           return_feat=False)["logits"]
            probs = torch.softmax(logits.float(), dim=1).permute(0, 2, 3, 1)
        refined = crf_refine(batch["features"][..., 1:4].float(), probs,
                             eval_mask, k)
        logp = torch.log(refined + 1e-10)
        label = train_label.long()
        picked = torch.gather(logp, -1, label[..., None])[..., 0]
        m = wss_mask.to(torch.float32)
        if args.class_balance:
            # inverse-frequency pixel weights from this batch's weak labels:
            # every class PRESENT in the batch contributes equally to the
            # kernel objective, so a skewed point share cannot teach the
            # kernel to smooth rare classes away (--class_balance help)
            n_cls = cfg.data.n_classes
            counts = all_reduce_sum(torch.zeros(
                n_cls, device=m.device).index_add_(
                0, label.reshape(-1), m.reshape(-1)), mesh)
            present = counts > 0
            w_cls = torch.where(present, 1.0 / counts.clamp_min(1.0), 0.0)
            w_cls = w_cls / present.sum().clamp_min(1)
            m = m * w_cls[label]
            return -(picked * m).sum() / all_reduce_sum(
                m.sum(), mesh).clamp_min(1e-12)
        # with a mesh, this rank's share of the global batch's weak-CE
        return -(picked * m).sum() / all_reduce_sum(
            m.sum(), mesh).clamp_min(1.0)

    def padded_epoch(epoch):
        """The rank's batches, then (a shorter stripe) its last batch with
        no weak label, which adds nothing but joins the collectives."""
        last = None
        for last in pipe.epoch(epoch):
            yield last
        for _ in range(n_steps - pipe.steps_per_epoch()):
            yield dict(last, train_label=np.zeros_like(last["train_label"]))

    history = []
    for epoch in range(args.epochs):
        losses = []
        for host_batch in padded_epoch(epoch):
            batch = batch_to_device(
                {k: host_batch[k] for k in BATCH_KEYS}, device)
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(kernel, batch)
            loss.backward()
            if mesh is not None:
                kernel.grad = all_reduce_sum(kernel.grad, mesh)
            opt.step()
            losses.append(all_reduce_sum(loss.detach(), mesh))
        mean = float(torch.stack(losses).mean())
        history.append(round(mean, 5))
        if rank == 0:
            print(f"epoch {epoch + 1}/{args.epochs} weak-CE {mean:.5f}",
                  flush=True)
    if mesh is not None:
        destroy_mesh()

    fitted = kernel.detach().cpu().numpy()
    if rank == 0:
        out_dir = os.path.dirname(args.out)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        np.savez(args.out, kernel=fitted,
                 history=np.asarray(history, np.float32))
        print(json.dumps({"out": args.out, "history": history}))
    return {"kernel": fitted, "history": history}


if __name__ == "__main__":
    main()
