"""Carry weights across: JAX variables or reference .pth -> port state dict.

``state_dict_from_jax`` maps the JAX package's SalsaNext variables
(``{"params", "batch_stats"}`` as nested dicts of arrays) to a PyTorch state
dict under the reference's parameter names, which the port's modules use,
so the result loads with ``load_state_dict(strict=True)``:

  conv       kernel (kh, kw, I, O)  -> weight (O, I, kh, kw), bias as is
  batchnorm  params scale / bias    -> weight / bias
             batch_stats mean / var -> running_mean / running_var

The entry table is the port's own copy of the JAX package's
``tools/convert_torch_ckpt.py:salsanext_entries`` (the port never imports
the JAX package); ``tests/test_torch_salsanext.py`` holds the output equal,
key for key, to that module's ``export_state_dict``.

``load_reference_state_dict`` reads a reference-named ``.pth`` (the
reference's own checkpoints, or ``torch.save(model.state_dict())`` of the
port) for ``tools/infer.py --weights``.
"""

from __future__ import annotations

import numpy as np
import torch


def _conv(t: str, f: str) -> list[tuple[str, str, tuple[str, ...]]]:
    return [("conv", t, tuple(f.split("/")))]


def _bn(t: str, f: str) -> list[tuple[str, str, tuple[str, ...]]]:
    return [("bn", t, tuple(f.split("/")))]


def _cab(torch_conv: str, torch_bn: str, flax_scope: str):
    """One reference conv+bn pair -> the JAX ConvActBN scope."""
    return (_conv(torch_conv, f"{flax_scope}/Conv_0")
            + _bn(torch_bn, f"{flax_scope}/BatchNorm_0"))


def salsanext_entries() -> list[tuple[str, str, tuple[str, ...]]]:
    """(kind, reference name, JAX module path) for every SalsaNext layer."""
    e = []
    for i, name in enumerate(["downCntx", "downCntx2", "downCntx3"]):
        scope = f"ResContextBlock_{i}"
        e += _conv(f"{name}.conv1", f"{scope}/Conv_0")
        e += _cab(f"{name}.conv2", f"{name}.bn1", f"{scope}/ConvActBN_0")
        e += _cab(f"{name}.conv3", f"{name}.bn2", f"{scope}/ConvActBN_1")
    for i in range(5):
        name, scope = f"resBlock{i + 1}", f"ResBlock_{i}"
        e += _conv(f"{name}.conv1", f"{scope}/Conv_0")
        for j in range(4):
            e += _cab(f"{name}.conv{j + 2}", f"{name}.bn{j + 1}",
                      f"{scope}/ConvActBN_{j}")
    for i in range(4):
        name, scope = f"upBlock{i + 1}", f"UpBlock_{i}"
        for j in range(4):
            e += _cab(f"{name}.conv{j + 1}", f"{name}.bn{j + 1}",
                      f"{scope}/ConvActBN_{j}")
    e += _conv("cls_head", "cls_head")
    e += _conv("projector.proj.0", "projector/Conv_0")
    e += _bn("projector.proj.1", "projector/BatchNorm_0")
    e += _conv("projector.proj.3", "projector/Conv_1")
    return e


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def state_dict_from_jax(variables, net_type: str = "salsanext"
                        ) -> dict[str, torch.Tensor]:
    """JAX ``{"params", "batch_stats"}`` -> port state dict (float32 CPU
    tensors). Raises KeyError naming the first layer the variables lack."""
    if net_type != "salsanext":
        raise NotImplementedError(
            f"net_type={net_type!r} is not ported yet (ROADMAP.md Queue 1 "
            "item 17); only 'salsanext' is")
    params = variables["params"]
    stats = variables.get("batch_stats", {})

    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    sd: dict[str, torch.Tensor] = {}
    for kind, t, path in salsanext_entries():
        node = _get(params, path)
        if kind == "conv":
            sd[f"{t}.weight"] = tensor(
                np.asarray(node["kernel"]).transpose(3, 2, 0, 1))
            if "bias" in node:
                sd[f"{t}.bias"] = tensor(node["bias"])
        else:
            sd[f"{t}.weight"] = tensor(node["scale"])
            sd[f"{t}.bias"] = tensor(node["bias"])
            sd[f"{t}.running_mean"] = tensor(_get(stats, path)["mean"])
            sd[f"{t}.running_var"] = tensor(_get(stats, path)["var"])
    return sd


# reference-model entries the port's SalsaNext has no counterpart for: the
# prototype memory and the feat_norm / mask_norm LayerNorm affines, which
# never receive gradients in the shipped trainer (the JAX converter drops
# them the same way)
_REFERENCE_ONLY = ("prototypes", "feat_norm.", "mask_norm.")


def load_reference_state_dict(path: str) -> dict[str, torch.Tensor]:
    """Load a reference-named ``.pth``: unwrap the reference's
    ``model`` / ``model_state`` / ``state_dict`` nesting and ``module.``
    prefixes, keep tensors only, drop reference-only entries."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(data, dict):
        for key in ("model", "model_state", "state_dict"):
            if key in data:
                data = data[key]
                break
    out = {}
    for k, v in data.items():
        k = k.removeprefix("module.")
        if torch.is_tensor(v) and not k.startswith(_REFERENCE_ONLY):
            out[k] = v
    return out
