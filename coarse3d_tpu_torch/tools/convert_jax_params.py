"""Carry weights across: JAX variables or reference .pth -> port state dict.

``state_dict_from_jax`` maps the JAX package's model variables
(``{"params", "batch_stats"}`` as nested dicts of arrays; SalsaNext,
RangeNet or SqueezeSegV3) to a PyTorch state dict under the reference's
parameter names, which the port's modules use, so the result loads with
``load_state_dict(strict=True)``:

  conv       kernel (kh, kw, I, O)  -> weight (O, I, kh, kw), bias as is
  convT      kernel (kh, kw, I, O)  -> weight (I, O, kh, kw), flipped in
             space: PyTorch's transposed conv convolves where Flax's
             correlates
  dense      kernel (I, O)          -> weight (O, I), bias as is
  batchnorm  params scale / bias    -> weight / bias
             batch_stats mean / var -> running_mean / running_var

The entry tables are the port's own copies of the JAX package's
``tools/convert_torch_ckpt.py`` ``salsanext_entries``, ``rangenet_entries``
and ``squeezesegv3_entries`` (the port never imports the JAX package);
``tests/test_torch_salsanext.py`` and ``tests/test_torch_families.py`` hold
the output equal, key for key, to that module's ``export_state_dict``. The
s2d stems' head (``cls_head_s2d``) and the classification head (``fc``)
have no reference counterpart; they are carried when the variables hold
them.

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


def _convT(t: str, f: str) -> list[tuple[str, str, tuple[str, ...]]]:
    return [("convT", t, tuple(f.split("/")))]


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
    e += _projector()
    return e


def _projector(prefix: str = "projector"):
    return (_conv(f"{prefix}.proj.0", f"{prefix}/Conv_0")
            + _bn(f"{prefix}.proj.1", f"{prefix}/BatchNorm_0")
            + _conv(f"{prefix}.proj.3", f"{prefix}/Conv_1"))


def _basic_block(torch_prefix: str, flax_scope: str):
    return (_cab(f"{torch_prefix}.conv1", f"{torch_prefix}.bn1",
                 f"{flax_scope}/ConvBN_0")
            + _cab(f"{torch_prefix}.conv2", f"{torch_prefix}.bn2",
                   f"{flax_scope}/ConvBN_1"))


# residual block counts per darknet depth
_BLOCKS = {21: (1, 1, 2, 2, 1), 53: (1, 2, 8, 8, 4)}


def rangenet_entries(layers: int = 21):
    blocks = _BLOCKS[layers]
    e = []
    e += _cab("backbone.conv1", "backbone.bn1", "ConvBN_0")
    bb = 0
    for s in range(5):
        e += _cab(f"backbone.enc{s + 1}.conv", f"backbone.enc{s + 1}.bn",
                  f"ConvBN_{s + 1}")
        for i in range(blocks[s]):
            e += _basic_block(f"backbone.enc{s + 1}.residual_{i}",
                              f"BasicBlock_{bb}")
            bb += 1
    for d in range(5):
        dec = f"decoder.dec{5 - d}"
        e += _convT(f"{dec}.upconv", f"UpConvBN_{d}/ConvTranspose_0")
        e += _bn(f"{dec}.bn", f"UpConvBN_{d}/BatchNorm_0")
        e += _basic_block(f"{dec}.residual", f"BasicBlock_{bb}")
        bb += 1
    e += _conv("head.1", "cls_head")
    e += _projector()
    return e


def _sac_block(torch_prefix: str, flax_scope: str):
    return (
        _conv(f"{torch_prefix}.attention_x.0", f"{flax_scope}/attention_conv")
        + _bn(f"{torch_prefix}.attention_x.1", f"{flax_scope}/attention_bn")
        + _conv(f"{torch_prefix}.position_mlp_2.0", f"{flax_scope}/Conv_0")
        + _bn(f"{torch_prefix}.position_mlp_2.1", f"{flax_scope}/BatchNorm_0")
        + _conv(f"{torch_prefix}.position_mlp_2.3", f"{flax_scope}/Conv_1")
        + _bn(f"{torch_prefix}.position_mlp_2.4", f"{flax_scope}/BatchNorm_1")
    )


def squeezesegv3_entries(layers: int = 21):
    blocks = _BLOCKS[layers]
    e = []
    e += _cab("backbone.conv1", "backbone.bn1", "ConvBN_0")
    sac = 0
    conv_bn = 1
    downsampled = (True, True, True, False, False)
    for s in range(5):
        for i in range(blocks[s]):
            e += _sac_block(f"backbone.enc{s + 1}.residual_{i}",
                            f"SACBlock_{sac}")
            sac += 1
        if downsampled[s]:
            e += _cab(f"backbone.enc{s + 1}.conv", f"backbone.enc{s + 1}.bn",
                      f"ConvBN_{conv_bn}")
            conv_bn += 1
    bb = 0
    up = 0
    for d, stride2 in zip(range(5), (False, False, True, True, True)):
        dec = f"decoder.dec{5 - d}"
        if stride2:
            e += _convT(f"{dec}.upconv", f"UpConvBN_{up}/ConvTranspose_0")
            e += _bn(f"{dec}.bn", f"UpConvBN_{up}/BatchNorm_0")
            up += 1
        else:
            e += _cab(f"{dec}.conv", f"{dec}.bn", f"ConvBN_{conv_bn}")
            conv_bn += 1
        e += _basic_block(f"{dec}.residual", f"BasicBlock_{bb}")
        bb += 1
    e += _conv("head5.1", "head5")
    e += _projector()
    return e


_ENTRIES = {
    "salsanext": lambda layers: salsanext_entries(),
    "rangenet": rangenet_entries,
    "squeezesegv3": squeezesegv3_entries,
}

# layers of SalsaNext's other modes, which the reference has not: the s2d
# stems' head takes the place of cls_head, the classification head that of
# the decoder
_SALSANEXT_OPTIONAL = (_conv("cls_head_s2d", "cls_head_s2d")
                       + [("dense", "fc.fc", ("fc", "Dense_0"))])


def _entries(params, net_type: str, layers: int):
    """The entry table of ``net_type``, fitted to what a SalsaNext tree
    holds: an s2d or classification model lacks ``cls_head`` (and, in
    classification mode, the decoder and the projector)."""
    if net_type not in _ENTRIES:
        raise ValueError(f"unknown net_type: {net_type}")
    entries = _ENTRIES[net_type](layers)
    if net_type == "salsanext":
        extra = [e for e in _SALSANEXT_OPTIONAL if e[2][0] in params]
        if extra:
            entries = [e for e in entries if e[2][0] in params] + extra
    return entries


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def params_from_jax(params, net_type: str = "salsanext", layers: int = 21
                    ) -> dict[str, torch.Tensor]:
    """A tree laid out like a JAX model's ``params`` (the params
    themselves, or optax moments of them) -> port parameter names."""
    sd: dict[str, torch.Tensor] = {}
    for kind, t, path in _entries(params, net_type, layers):
        node = _get(params, path)
        if kind in ("conv", "convT", "dense"):
            kernel = np.asarray(node["kernel"])
            if kind == "conv":
                weight = kernel.transpose(3, 2, 0, 1)
            elif kind == "convT":
                # unflip, then (kh, kw, I, O) -> (I, O, kh, kw)
                weight = kernel[::-1, ::-1].transpose(2, 3, 0, 1)
            else:
                weight = kernel.T
            sd[f"{t}.weight"] = _tensor(weight)
            if "bias" in node:
                sd[f"{t}.bias"] = _tensor(node["bias"])
        else:
            sd[f"{t}.weight"] = _tensor(node["scale"])
            sd[f"{t}.bias"] = _tensor(node["bias"])
    return sd


def state_dict_from_jax(variables, net_type: str = "salsanext",
                        layers: int = 21) -> dict[str, torch.Tensor]:
    """JAX ``{"params", "batch_stats"}`` -> port state dict (float32 CPU
    tensors). Raises KeyError naming the first layer the variables lack."""
    params = params_from_jax(variables["params"], net_type, layers)
    stats = variables.get("batch_stats", {})
    sd: dict[str, torch.Tensor] = {}
    for kind, t, path in _entries(variables["params"], net_type, layers):
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


def train_state_from_jax(state, net_type: str = "salsanext",
                         layers: int = 21) -> dict:
    """The JAX package's ``TrainState`` (its fields: ``params``,
    ``batch_stats``, ``opt_state`` of ``optax.adamw``, ``prototypes``,
    ``step``) -> what the port's ``TrainState.load`` takes:

      {"model": state dict, "prototypes": (C, K, D) tensor, "step": int,
       "optimizer": {param name: {"exp_avg", "exp_avg_sq", "step"}}}

    Adam's ``mu`` / ``nu`` are laid out like the params, so they go through
    the same mapping (conv kernels (kh, kw, I, O) -> (O, I, kh, kw)).
    """
    adam = _adam_moments(state.opt_state)
    if adam is None:
        raise ValueError("opt_state holds no Adam moments (mu, nu)")
    mu = params_from_jax(adam.mu, net_type, layers)
    nu = params_from_jax(adam.nu, net_type, layers)
    count = int(np.asarray(adam.count))
    return {
        "model": state_dict_from_jax(
            {"params": state.params, "batch_stats": state.batch_stats},
            net_type, layers),
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
