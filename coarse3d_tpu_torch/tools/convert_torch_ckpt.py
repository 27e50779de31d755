"""Check a reference PyTorch checkpoint against a model family and write a
port state dict.

Port of the JAX package's ``tools/convert_torch_ckpt.py``, same CLI. There,
a released COARSE3D ``.pth`` (best_{3DAcc,3DIOU}_model.pth, BASELINE config
#1) is mapped onto Flax module paths and written as ``.msgpack``. The port's
modules keep the reference's parameter names and layouts, so a reference
``.pth`` already is its weight format (``tools/evaluate.py --weights`` and
``tools/infer.py --weights`` read one through
``convert_jax_params.load_reference_state_dict``). What is left to do, and
what this tool does:

- normalise the checkpoint: unwrap the reference's ``model`` /
  ``model_state`` / ``state_dict`` nesting and ``module.`` prefixes, keep
  tensors, drop the reference-only entries (the prototype memory, the
  never-trained ``feat_norm`` / ``mask_norm`` affines);
- check it against the family's layers (the entry tables of
  ``convert_jax_params``) and warn, in the JAX tool's words, of the
  reference layers it lacks;
- load the result into the family's model on ``--device`` (number of
  classes and projector width read from the checkpoint), strictly when no
  layer is absent;
- write the plain port state dict (the family's layers in table order,
  floating tensors in float32, BatchNorm step counts where the checkpoint
  has them) to ``--out``, creating its directory
  (``tools/baseline_matrix.py`` points it into ``<work>/converted/``).

CLI:
  python -m coarse3d_tpu_torch.tools.convert_torch_ckpt \
      --pth best_3DIOU_model.pth --net salsanext --out converted.pth
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch

# the layer whose weight gives each family's number of classes
_HEADS = {"salsanext": "cls_head", "rangenet": "head.1",
          "squeezesegv3": "head5.1"}
_PROJECTOR = "projector.proj.3"


def convert_checkpoint(state_dict: dict[str, torch.Tensor], net: str,
                       layers: int = 21
                       ) -> tuple[dict[str, torch.Tensor], list[str]]:
    """A normalised reference state dict -> (the family's layers as a port
    state dict, floating tensors in float32; the reference layers it
    lacks)."""
    from coarse3d_tpu_torch.tools.convert_jax_params import _ENTRIES

    out: dict[str, torch.Tensor] = {}
    missing: list[str] = []
    for kind, name, _ in _ENTRIES[net](layers):
        if f"{name}.weight" not in state_dict:
            missing.append(name)
            continue
        keys = ("weight", "bias") + (
            ("running_mean", "running_var", "num_batches_tracked")
            if kind == "bn" else ())
        for key in keys:
            # a conv may have no bias; the JAX package's exports carry no
            # BatchNorm step count (a PyTorch model's does)
            tensor = state_dict.get(f"{name}.{key}")
            if tensor is not None:
                if tensor.is_floating_point():
                    tensor = tensor.to(torch.float32)
                out[f"{name}.{key}"] = tensor.contiguous().clone()
    return out, missing


def family_config(state_dict: dict[str, torch.Tensor], net: str,
                  layers: int = 21):
    """The ``kitti`` preset fitted to a checkpoint of ``net``: its number
    of classes and projector width, where the checkpoint holds them."""
    from coarse3d_tpu_torch.configs import preset

    cfg = preset("kitti")
    head = state_dict.get(f"{_HEADS[net]}.weight")
    proj = state_dict.get(f"{_PROJECTOR}.weight")
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(
            cfg.data, n_classes=(head.shape[0] if head is not None
                                 else cfg.data.n_classes)),
        model=dataclasses.replace(cfg.model, net_type=net, layers=layers),
        contrast=dataclasses.replace(
            cfg.contrast, proj_dim=(proj.shape[0] if proj is not None
                                    else cfg.contrast.proj_dim)))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pth", required=True)
    p.add_argument("--net", default="salsanext",
                   choices=["salsanext", "rangenet", "squeezesegv3"])
    p.add_argument("--layers", type=int, default=21)
    p.add_argument("--out", required=True, help=".pth output")
    p.add_argument("--device", default="cuda",
                   help="device of the load check: 'cuda' (default; fails "
                        "without a card) or 'cpu'")
    args = p.parse_args(argv)

    from coarse3d_tpu_torch.device import resolve_device
    from coarse3d_tpu_torch.tools.convert_jax_params import (
        load_reference_state_dict,
    )
    from coarse3d_tpu_torch.train.setup import build_model

    device = resolve_device(args.device)
    sd = load_reference_state_dict(args.pth)
    converted, missing = convert_checkpoint(sd, args.net, args.layers)
    if missing:
        print(f"WARNING: {len(missing)} reference layers absent: "
              f"{missing[:5]}...")
    model = build_model(family_config(sd, args.net, args.layers),
                        device=device)
    model.load_state_dict(converted, strict=not missing)
    out_dir = os.path.dirname(args.out)
    if out_dir:
        # callers like baseline_matrix point --out into <work>/converted/
        os.makedirs(out_dir, exist_ok=True)
    torch.save(converted, args.out)
    print(f"converted {len(sd)} torch tensors -> {args.out}")
    return converted


if __name__ == "__main__":
    main()
