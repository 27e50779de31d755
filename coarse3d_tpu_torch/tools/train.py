"""Training CLI.

Port of the JAX package's ``tools/train.py``. Behavioral model:
tasks/weak_segmentation/main.py:178-198 + run.sh: config from YAML or a
preset, experiment dir stamped with date + id, optional resume. One
process, one card (``--device cpu`` for the CPU); with ``--multihost``, one
process per card under ``torchrun``, data-parallel over the global batch
(``parallel/mesh.py``): each process reads its stripe of the catalog with
``--batch_size`` scans per step (the global batch is that times the
number of processes), and only rank 0 logs and writes checkpoints. Any
``model.net_type`` / ``model.layers`` / ``model.stem`` the config or
``--set`` names is built.

  python -m coarse3d_tpu_torch.tools.train --preset semantic_kitti \
      --pcd_root .../sequences --weak_root .../weak --id v1.0
  python -m coarse3d_tpu_torch.tools.train --synthetic 32 --epochs 2   # smoke
  torchrun --nproc_per_node=4 -m coarse3d_tpu_torch.tools.train \
      --multihost --preset semantic_kitti ...                    # 4 cards
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", help="YAML config (preset + overrides)")
    p.add_argument("--preset", default="semantic_kitti")
    p.add_argument("--id", default="v1.0", dest="experiment_id")
    p.add_argument("--pcd_root")
    p.add_argument("--weak_root")
    p.add_argument("--weak_label_name")
    p.add_argument("--epochs", type=int)
    p.add_argument("--batch_size", type=int)
    p.add_argument("--save_path")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--val_only", action="store_true")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--synthetic", type=int, default=0, metavar="N_SCANS",
                   help="train on N synthetic scans (tiny smoke run)")
    p.add_argument("--synthetic_points", type=int, default=20000)
    p.add_argument("--synthetic_task", choices=("bands", "hard"),
                   default="bands",
                   help="synthetic label structure: 'bands' (elevation bands"
                        ", geometrically separable smoke task) or 'hard' "
                        "(texture-frequency classes — the contrast-ablation "
                        "benchmark, see data/synthetic.py)")
    p.add_argument("--synthetic_weak_ratio", type=float, default=None,
                   help="weak-annotation fraction for synthetic scans "
                        "(default: 0.002 bands / 0.0001 hard)")
    p.add_argument("--synthetic_segments", type=int, default=None,
                   help="hard task: yaw sectors per scan (default 6)")
    p.add_argument("--synthetic_modes", type=int, default=None,
                   help="hard task: texture modes per class (default 2)")
    p.add_argument("--synthetic_noise", type=float, default=None,
                   help="hard task: per-point intensity noise sigma "
                        "(default 0.15)")
    p.add_argument("--synthetic_label_noise", type=float, default=None,
                   help="hard task: weak-label flip fraction (default 0)")
    p.add_argument("--synthetic_imbalance", type=float, default=None,
                   help="hard task: geometric class point-share skew "
                        "(max/min ratio; default 0 = balanced sectors)")
    p.add_argument("--pretrained", help="reference-named .pth state dict to "
                   "warm-start from (the reference's pretrained_model, or "
                   "torch.save(model.state_dict()) of this package)")
    p.add_argument("--only_encoder", action="store_true",
                   help="restrict --pretrained to encoder parameters "
                        "(reference encoder_module.yaml semantics)")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="SECTION.KEY=VALUE",
                   help="config override, e.g. --set train.lr=0.02 "
                        "--set contrast.loss_w_contrast=0 (values parsed "
                        "as YAML; repeatable)")
    p.add_argument("--stem", choices=("parity", "s2d", "s2d_w"),
                   help="model stem override: 'parity' (reference-exact), "
                        "'s2d' (2x2 space-to-depth) or 's2d_w' (width-only "
                        "1x2, full row resolution)")
    p.add_argument("--multihost", action="store_true",
                   help="one process per card under torchrun: data-parallel "
                        "training over the global batch (NCCL on cards, "
                        "gloo with --device cpu)")
    p.add_argument("--profile_steps", type=int, nargs=2, default=None,
                   metavar=("FIRST", "LAST"),
                   help="torch.profiler trace window within epoch 0, "
                        "written to <save_path>/profile/trace.json with the "
                        "step's spans on a track of their own")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; fails without a card) or 'cpu'")
    args = p.parse_args(argv)

    if args.pretrained and args.resume:
        raise SystemExit(
            "cannot use pretrained weights and checkpoint resume together "
            "(reference trainer.py:71-73)")

    from coarse3d_tpu_torch.device import resolve_device
    from coarse3d_tpu_torch.parallel import destroy_mesh, make_mesh

    mesh = make_mesh(args.device) if args.multihost else None
    try:
        return _run(args, mesh, mesh.device if mesh else resolve_device(
            args.device))
    finally:
        if mesh is not None:
            destroy_mesh()


def _run(args, mesh, device):
    from coarse3d_tpu_torch.configs import apply_overrides, load_config, preset
    from coarse3d_tpu_torch.data.pipeline import DataPipeline
    from coarse3d_tpu_torch.train.trainer import Trainer
    from coarse3d_tpu_torch.utils import Recorder

    cfg = load_config(args.config) if args.config else preset(args.preset)
    if args.overrides:
        cfg = apply_overrides(cfg, args.overrides)

    data_over = {}
    for key in ("pcd_root", "weak_root", "weak_label_name"):
        if getattr(args, key):
            data_over[key] = getattr(args, key)
    train_over = {}
    if args.epochs:
        train_over["n_epochs"] = args.epochs
    if args.batch_size:
        train_over["batch_size_train"] = args.batch_size
        train_over["batch_size_val"] = args.batch_size
    if args.synthetic:
        data_over["dataset"] = "synthetic"
    model_over = {}
    if args.stem:
        model_over["stem"] = args.stem
    cfg = dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, **data_over),
        train=dataclasses.replace(cfg.train, **train_over),
        model=dataclasses.replace(cfg.model, **model_over),
        experiment_id=args.experiment_id,
        save_path=args.save_path or os.path.join(
            cfg.save_path,
            f"{datetime.date.today()}_{args.experiment_id}"),
    )

    if args.synthetic:
        from coarse3d_tpu_torch.data.synthetic import (SyntheticDataset,
                                                 SyntheticHardDataset,
                                                 hard_task_kwargs)

        ds_cls = (SyntheticHardDataset if args.synthetic_task == "hard"
                  else SyntheticDataset)
        ds_kw = ({"weak_ratio": args.synthetic_weak_ratio}
                 if args.synthetic_weak_ratio is not None else {})
        if args.synthetic_task == "hard":
            ds_kw.update(hard_task_kwargs(args))
        train_ds = ds_cls(
            args.synthetic, args.synthetic_points, cfg.data.n_classes,
            cfg.sensor, seed=cfg.train.seed, **ds_kw)
        val_ds = ds_cls(
            max(args.synthetic // 4, 1), args.synthetic_points,
            cfg.data.n_classes, cfg.sensor, seed=cfg.train.seed + 1, **ds_kw)
    else:
        from coarse3d_tpu_torch.data.datasets import build_dataset

        train_ds = build_dataset(cfg, "train")
        val_ds = build_dataset(cfg, "val")

    rank, world = (mesh.rank, mesh.world) if mesh else (0, 1)
    recorder = Recorder(
        cfg.save_path, settings=cfg,
        snapshot_code_root=os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))),
        enabled=rank == 0)
    recorder.logger.info(f"device: {device}, rank {rank} of {world}")
    recorder.logger.info(f"save_path: {cfg.save_path}")

    # batches are stacked into page-locked memory for a card, so their
    # copies run beside the previous step (4 scans per GPU in run.sh);
    # each process reads its stripe of the catalog
    pin = device.type == "cuda"
    stripe = dict(process_index=rank, process_count=world)
    train_pipe = DataPipeline(
        train_ds, cfg, cfg.train.batch_size_train, train=True,
        seed=cfg.train.seed, num_workers=args.num_workers, pin_memory=pin,
        **stripe)
    val_pipe = DataPipeline(
        val_ds, cfg, cfg.train.batch_size_val, train=False,
        seed=cfg.train.seed, num_workers=args.num_workers, pin_memory=pin,
        **stripe)

    trainer = Trainer(cfg, train_pipe, val_pipe, recorder=recorder,
                      device=device, mesh=mesh)
    trainer.install_signal_handlers()
    if args.profile_steps:
        trainer.profile_steps = tuple(args.profile_steps)
    if args.pretrained:
        from coarse3d_tpu_torch.models.salsanext import ENCODER_PREFIXES
        from coarse3d_tpu_torch.tools.convert_jax_params import (
            load_reference_state_dict,
        )
        from coarse3d_tpu_torch.train.checkpoint import load_pretrained_params

        prefixes = ENCODER_PREFIXES if args.only_encoder else ()
        trainer.state, copied = load_pretrained_params(
            trainer.state, load_reference_state_dict(args.pretrained),
            only_prefixes=prefixes)
        recorder.logger.info(
            f"loaded {copied} pretrained tensors from {args.pretrained}"
            f"{' (encoder only)' if args.only_encoder else ''}")
    if args.resume:
        trainer.maybe_resume()
    if args.val_only:
        return trainer.run_epoch(trainer.start_epoch, "Validation")
    trainer.fit()
    return trainer


if __name__ == "__main__":
    main()
