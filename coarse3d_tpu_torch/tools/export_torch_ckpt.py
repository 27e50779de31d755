"""Export weights to a reference-loadable PyTorch ``.pth``.

Port of the JAX package's ``tools/export_torch_ckpt.py``, same CLI plus
``--device``. Weights trained by ``tools/train.py`` (a run directory), or
Flax variables (a ``.msgpack`` the JAX package wrote), go out under the
reference's module names and layouts as ``{"model_state": state dict,
"epoch": epoch}``, which the reference's ``SalsaNextProto`` /
``RangeNetProto`` / ``SqueezeSegV3Proto`` load through
``checkpoint["model_state"]`` (its trainer.py:108-133), and which the
port's ``--weights`` flags read back.

- ``--run_dir``: the latest rolling checkpoint of the run
  (``train/checkpoint.py``) is restored into a state built on
  ``--device``; ``epoch`` is the epoch a resumed run would start at, as in
  the JAX tool. The port's modules already carry the reference's names, so
  the model's state dict is written as it is, with the prototype memory.
- ``--msgpack``: read without Flax (``tools/_flax_msgpack.py``), mapped by
  ``convert_jax_params.state_dict_from_jax``; ``epoch`` is None. This path
  touches no device, so it runs on any host and ignores ``--device``.

Only the parity stem maps onto the reference architecture; an s2d stem is
refused.

  python -m coarse3d_tpu_torch.tools.export_torch_ckpt --run_dir runs/v1.0 \
      --preset semantic_kitti --out model.pth
  python -m coarse3d_tpu_torch.tools.export_torch_ckpt \
      --msgpack converted.msgpack --net salsanext --n_classes 20 \
      --out model.pth
"""

from __future__ import annotations

import argparse
import dataclasses


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--run_dir", help="training run dir (tools/train.py)")
    src.add_argument("--msgpack", help="flax .msgpack variables")
    p.add_argument("--preset", default="semantic_kitti",
                   help="config preset (for --run_dir state restore)")
    p.add_argument("--net", default=None,
                   choices=["salsanext", "rangenet", "squeezesegv3"],
                   help="overrides the preset's net_type for --msgpack")
    p.add_argument("--layers", type=int, default=21)
    p.add_argument("--n_classes", type=int)
    p.add_argument("--out", required=True, help=".pth output")
    p.add_argument("--device", default="cuda",
                   help="device of the --run_dir restore: 'cuda' (default; "
                        "fails without a card) or 'cpu'; --msgpack reads "
                        "on the host and ignores it")
    args = p.parse_args(argv)

    import torch

    from coarse3d_tpu_torch.configs import preset
    from coarse3d_tpu_torch.device import resolve_device

    cfg = preset(args.preset)
    net = args.net or cfg.model.net_type

    if args.msgpack:
        from coarse3d_tpu_torch.tools._flax_msgpack import restore
        from coarse3d_tpu_torch.tools.convert_jax_params import (
            state_dict_from_jax,
        )

        with open(args.msgpack, "rb") as f:
            variables = restore(f.read())
        if "cls_head_s2d" in variables.get("params", {}):
            raise SystemExit(
                "these weights use the s2d stem (cls_head_s2d present); "
                "only the parity stem maps onto the reference architecture")
        try:
            sd = state_dict_from_jax(variables, net, args.layers)
        except KeyError as err:
            raise SystemExit(f"{args.msgpack}: no {net} layer {err}") from err
        if "prototypes" in variables:
            sd["prototypes"] = torch.from_numpy(
                variables["prototypes"].astype("float32"))
        epoch = None
    else:
        from coarse3d_tpu_torch.train.checkpoint import CheckpointManager
        from coarse3d_tpu_torch.train.setup import build_state

        if args.n_classes:
            cfg = dataclasses.replace(
                cfg, data=dataclasses.replace(cfg.data,
                                              n_classes=args.n_classes))
        if cfg.model.stem != "parity":
            raise SystemExit("only the parity stem maps onto the reference "
                             "architecture (got stem="
                             f"{cfg.model.stem!r})")
        state = build_state(cfg, device=resolve_device(args.device),
                            steps_per_epoch=1)
        state, epoch = CheckpointManager(args.run_dir).restore(state)
        sd = {k: v.detach().cpu()
              for k, v in state.model.state_dict().items()}
        sd["prototypes"] = state.prototypes.cpu()

    torch.save({"model_state": sd, "epoch": epoch}, args.out)
    print(f"exported {len(sd)} tensors -> {args.out} "
          f"(reference load: model.load_state_dict("
          f"torch.load(...)['model_state'], strict=False))")
    return sd, epoch


if __name__ == "__main__":
    main()
