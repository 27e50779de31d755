"""Port SalsaNext (coarse3d_tpu_torch.models) vs the JAX model, on the CPU
in float32: JAX-initialised variables (BN statistics and affines
randomised) carried across by ``state_dict_from_jax`` and loaded strictly;
logits / probs within atol 1e-4, the embedding within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coarse3d_tpu.models import SalsaNext as JaxSalsaNext
from coarse3d_tpu.models.blocks import pixel_shuffle as jax_pixel_shuffle
from coarse3d_tpu.ops.resize import resize_bilinear as jax_resize
from coarse3d_tpu.tools.convert_torch_ckpt import export_state_dict
from coarse3d_tpu_torch.configs import preset
from coarse3d_tpu_torch.models.blocks import pixel_shuffle
from coarse3d_tpu_torch.models.salsanext import SalsaNext
from coarse3d_tpu_torch.ops.resize import resize_bilinear
from coarse3d_tpu_torch.tools.convert_jax_params import (
    load_reference_state_dict,
    state_dict_from_jax,
)
from coarse3d_tpu_torch.train.setup import build_model

C, PROJ = 8, 32


def _randomize(tree, rng, leaf_fn):
    return {k: _randomize(v, rng, leaf_fn) if isinstance(v, dict)
            else leaf_fn(k, np.asarray(v), rng) for k, v in tree.items()}


def jax_variables(model, shape, seed=0):
    """JAX-initialised variables as numpy trees, BN made non-trivial."""
    variables = model.init({"params": jax.random.key(seed)},
                           jnp.zeros(shape), train=False, return_feat=True)
    rng = np.random.default_rng(seed)

    def stats(k, v, rng):
        if k == "mean":
            return rng.normal(0, 0.5, v.shape).astype(np.float32)
        return rng.uniform(0.5, 2.0, v.shape).astype(np.float32)

    def params(k, v, rng):
        if k == "scale":
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if k == "bias":
            return rng.normal(0, 0.1, v.shape).astype(np.float32)
        return v

    return {"params": _randomize(jax.device_get(variables["params"]), rng,
                                 params),
            "batch_stats": _randomize(
                jax.device_get(variables["batch_stats"]), rng, stats)}


def _port(variables, **kw):
    model = SalsaNext(n_classes=C, proj_dim=PROJ,
                      compute_dtype=torch.float32, **kw)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def tiny():
    jmodel = JaxSalsaNext(n_classes=C, proj_dim=PROJ, dtype=jnp.float32)
    return jmodel, jax_variables(jmodel, (2, 16, 64, 5))


def test_state_dict_equals_export_state_dict(tiny):
    _, variables = tiny
    want, missing = export_state_dict(variables, "salsanext")
    assert not missing
    got = state_dict_from_jax(variables)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # exactly the port model's parameters and buffers
    port_keys = {k for k in SalsaNext(n_classes=C, proj_dim=PROJ).state_dict()
                 if not k.endswith("num_batches_tracked")}
    assert set(got) == port_keys


@pytest.mark.parametrize("pad_hw,shape", [(0, (2, 16, 64)), (8, (1, 24, 56))])
def test_forward_matches_jax(pad_hw, shape):
    b, h, w = shape
    jmodel = JaxSalsaNext(n_classes=C, proj_dim=PROJ, dtype=jnp.float32,
                          pad_hw=pad_hw)
    variables = jax_variables(jmodel, (b, h, w, 5), seed=pad_hw + 1)
    x = np.random.default_rng(7).normal(size=(b, h, w, 5)).astype(np.float32)
    want = jmodel.apply(variables, jnp.asarray(x), train=False,
                        return_feat=True)
    with torch.no_grad():
        got = _port(variables, pad_hw=pad_hw)(
            torch.from_numpy(x).permute(0, 3, 1, 2), return_feat=True)
    for k, atol in (("logits", 1e-4), ("probs", 1e-4), ("embedding", 1e-5)):
        g = got[k].permute(0, 2, 3, 1).numpy()
        wk = np.asarray(want[k])
        assert g.shape == wk.shape, k
        err = np.abs(g - wk).max()
        print(f"{k} max abs err {err}")
        np.testing.assert_allclose(g, wk, rtol=0, atol=atol, err_msg=k)


def test_pixel_shuffle_and_resize_match_jax():
    x = np.random.default_rng(3).normal(size=(2, 4, 6, 12)).astype(np.float32)
    want = np.asarray(jax_pixel_shuffle(jnp.asarray(x), 2))
    got = pixel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2), 2)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    for out_h, out_w in [(8, 12), (2, 3), (4, 6)]:
        want = np.asarray(jax_resize(jnp.asarray(x), out_h, out_w))
        got = resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2),
                              out_h, out_w)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                   rtol=0, atol=1e-5)


def test_build_model_wiring():
    cfg = preset("tiny")
    model = build_model(cfg, device="cpu", seed=3)
    assert not model.training and model.compute_dtype == torch.float32
    again = build_model(cfg, device="cpu", seed=3)
    for (k, a), b in zip(model.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k          # the seed fixes the weights
    assert build_model(preset("kitti"), device="cpu").compute_dtype == (
        torch.bfloat16)
    assert build_model(preset("poss"), device="cpu").pad_hw == 8


@pytest.mark.parametrize("section,field,value", [
    ("model", "net_type", "rangenet"), ("model", "stem", "s2d")])
def test_build_model_unported_options_raise(section, field, value):
    """These options were refused once; now they build (held against JAX in
    tests/test_torch_families.py). The 2x2 stem needs 32 rows."""
    import dataclasses

    cfg = preset("tiny")
    cfg = dataclasses.replace(
        cfg, sensor=dataclasses.replace(cfg.sensor, proj_h=32),
        **{section: dataclasses.replace(getattr(cfg, section),
                                        **{field: value})})
    model = build_model(cfg, device="cpu")
    with torch.no_grad():
        out = model(torch.zeros(1, 5, 32, 64))
    assert out["logits"].shape == (1, cfg.data.n_classes, 32, 64)
    assert (model.__class__.__name__ == "RangeNet") == (value == "rangenet")


def test_load_reference_state_dict_unwraps(tmp_path):
    sd = SalsaNext(n_classes=C, proj_dim=PROJ).state_dict()
    wrapped = {"model": {"module." + k: v for k, v in sd.items()}
               | {"module.prototypes": torch.zeros(C, 4, PROJ),
                  "module.feat_norm.weight": torch.ones(PROJ)},
               "epoch": 3}
    path = tmp_path / "ckpt.pth"
    torch.save(wrapped, path)
    loaded = load_reference_state_dict(str(path))
    assert set(loaded) == set(sd)
    SalsaNext(n_classes=C, proj_dim=PROJ).load_state_dict(loaded, strict=True)


def test_train_forward_running_stats_match_flax(tiny):
    """One train-mode forward folds the batch statistics into the running
    ones as Flax does: the BIASED batch variance into the variance (plain
    ``torch.nn.BatchNorm2d`` folds the unbiased one, 5e-5 relative off at
    this size). Dropout is 0 on both sides: Flax's dropout stream cannot be
    reproduced. rtol 1e-5 on both; the mean also gets atol 1e-5 (2e-5 of
    its 0.5 scale): a running mean can sit near 0, where 30 layers of float
    noise in the forward leave it up to 1e-6 off in absolute terms."""
    _, variables = tiny
    jmodel = JaxSalsaNext(n_classes=C, proj_dim=PROJ, dtype=jnp.float32,
                          dropout_rate=0.0)
    # 32x128 keeps 32 samples per channel in the deepest block, where the
    # unbiased fold is 1/31 of the batch term off; at 16x64 (8 samples)
    # float noise of the forward alone reaches 1.6e-5 there
    x = np.random.default_rng(11).normal(size=(2, 32, 128, 5)).astype(
        np.float32)
    _, mutated = jmodel.apply(variables, jnp.asarray(x), train=True,
                              return_feat=True, mutable=["batch_stats"],
                              rngs={"dropout": jax.random.key(0)})
    want = state_dict_from_jax({"params": variables["params"],
                                "batch_stats": mutated["batch_stats"]})
    model = _port(variables, dropout_rate=0.0).train()
    with torch.no_grad():
        model(torch.from_numpy(x).permute(0, 3, 1, 2), return_feat=True)
    got = model.state_dict()
    worst = {"running_mean": 0.0, "running_var": 0.0}
    for k, w in want.items():
        kind = k.rsplit(".", 1)[1]
        if kind not in worst:
            continue
        g, w = got[k].numpy(), w.numpy()
        worst[kind] = max(worst[kind],
                          float(np.max(np.abs(g - w) / np.abs(w))))
        np.testing.assert_allclose(
            g, w, rtol=1e-5, atol=1e-5 if kind == "running_mean" else 0,
            err_msg=k)
    print(f"max relative error {worst}")
