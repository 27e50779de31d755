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

``train_state_from_jax`` carries a whole JAX training state across: the
model state dict, the prototype memory, the step and AdamW's moments, for
``train/state.py:TrainState.load``.

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


def _check_net(net_type: str) -> None:
    if net_type != "salsanext":
        raise NotImplementedError(
            f"net_type={net_type!r} is not ported yet (ROADMAP.md Queue 1 "
            "item 17); only 'salsanext' is")


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def params_from_jax(params) -> dict[str, torch.Tensor]:
    """A tree laid out like the JAX SalsaNext ``params`` (the params
    themselves, or optax moments of them) -> port parameter names."""
    sd: dict[str, torch.Tensor] = {}
    for kind, t, path in salsanext_entries():
        node = _get(params, path)
        if kind == "conv":
            sd[f"{t}.weight"] = _tensor(
                np.asarray(node["kernel"]).transpose(3, 2, 0, 1))
            if "bias" in node:
                sd[f"{t}.bias"] = _tensor(node["bias"])
        else:
            sd[f"{t}.weight"] = _tensor(node["scale"])
            sd[f"{t}.bias"] = _tensor(node["bias"])
    return sd


def state_dict_from_jax(variables, net_type: str = "salsanext"
                        ) -> dict[str, torch.Tensor]:
    """JAX ``{"params", "batch_stats"}`` -> port state dict (float32 CPU
    tensors). Raises KeyError naming the first layer the variables lack."""
    _check_net(net_type)
    params = params_from_jax(variables["params"])
    stats = variables.get("batch_stats", {})
    sd: dict[str, torch.Tensor] = {}
    for kind, t, path in salsanext_entries():
        for name in ("weight", "bias"):
            if f"{t}.{name}" in params:
                sd[f"{t}.{name}"] = params[f"{t}.{name}"]
        if kind == "bn":
            sd[f"{t}.running_mean"] = _tensor(_get(stats, path)["mean"])
            sd[f"{t}.running_var"] = _tensor(_get(stats, path)["var"])
    return sd


def _adam_moments(opt_state):
    """The (count, mu, nu) of the Adam transform inside an optax chain: the
    one node of the state tree with ``mu`` and ``nu`` fields."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _adam_moments(sub)
            if found is not None:
                return found
    return None


def train_state_from_jax(state, net_type: str = "salsanext") -> dict:
    """The JAX package's ``TrainState`` (its fields: ``params``,
    ``batch_stats``, ``opt_state`` of ``optax.adamw``, ``prototypes``,
    ``step``) -> what the port's ``TrainState.load`` takes:

      {"model": state dict, "prototypes": (C, K, D) tensor, "step": int,
       "optimizer": {param name: {"exp_avg", "exp_avg_sq", "step"}}}

    Adam's ``mu`` / ``nu`` are laid out like the params, so they go through
    the same mapping (conv kernels (kh, kw, I, O) -> (O, I, kh, kw)).
    """
    _check_net(net_type)
    adam = _adam_moments(state.opt_state)
    if adam is None:
        raise ValueError("opt_state holds no Adam moments (mu, nu)")
    mu = params_from_jax(adam.mu)
    nu = params_from_jax(adam.nu)
    count = int(np.asarray(adam.count))
    return {
        "model": state_dict_from_jax(
            {"params": state.params, "batch_stats": state.batch_stats},
            net_type),
        "prototypes": _tensor(state.prototypes),
        "step": int(np.asarray(state.step)),
        "optimizer": {name: {"exp_avg": mu[name], "exp_avg_sq": nu[name],
                             "step": count} for name in mu},
    }


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
