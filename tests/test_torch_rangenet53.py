"""The port's RangeNet at 53 layers against the JAX package's on the CPU in
float32, and the spans its forward records inside the serving path.

``tests/test_torch_families.py`` runs RangeNet's forwards at 21 layers;
this file holds the 53-layer forward (1, 2, 8, 8 and 4 residual blocks)
at 8x64, B=1, with JAX-initialised variables carried across by
``state_dict_from_jax``, under that file's tolerances and dropout
handling: logits and probs within atol 1e-4, the embedding within 1e-5;
in train mode, with JAX's dropout made the identity and the port's set to
p = 0, the BatchNorm running statistics within rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from coarse3d_tpu.tools.convert_torch_ckpt import convert_state_dict
from coarse3d_tpu_torch.configs import preset
from coarse3d_tpu_torch.data.synthetic import pad_points, synthetic_scan
from coarse3d_tpu_torch.eval.inference import make_inference_fn
from coarse3d_tpu_torch.models.rangenet import RangeNet
from coarse3d_tpu_torch.tools.convert_jax_params import state_dict_from_jax
from coarse3d_tpu_torch.train.setup import build_model
from coarse3d_tpu_torch.utils.profiling import traced_spans
from tests.test_torch_families import (
    PROJ,
    C,
    _compare_forward,
    _identity_dropout,
    _jax_model,
    _no_dropout,
    _port_model,
)

SHAPE = (1, 8, 64, 5)


@pytest.fixture(scope="module")
def variables():
    """Flax variables of RangeNet-53, made on the port's side and carried
    by the JAX package's ``convert_state_dict`` (Flax's eager ``init`` of
    53 layers takes half a minute; the JAX forwards are jitted for the same
    reason): PyTorch's default weights, BatchNorm randomised as
    ``jax_variables`` does."""
    torch.manual_seed(53)
    model = RangeNet(n_classes=C, layers=53, proj_dim=PROJ)
    gen = torch.Generator().manual_seed(53)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.5, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    sd = model.state_dict()
    out = convert_state_dict({k: v.numpy() for k, v in sd.items()
                              if not k.endswith("num_batches_tracked")},
                             "rangenet", 53)
    assert "missing" not in out
    return out


def _input():
    return np.random.default_rng(17).normal(size=SHAPE).astype(np.float32)


def test_rangenet53_forward_matches_jax(variables):
    x = _input()
    jmodel = _jax_model("rangenet", 53)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False,
                                             return_feat=True))(
        variables, jnp.asarray(x))
    model = _port_model("rangenet", variables, layers=53)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2),
                    return_feat=True)
    _compare_forward(want, got)


def test_rangenet53_train_forward_matches_jax(variables, monkeypatch):
    """One train-mode forward: the logits from batch statistics, and the
    running statistics each of the 53 layers' BatchNorms folds in."""
    _identity_dropout(monkeypatch)
    x = _input()
    jmodel = _jax_model("rangenet", 53)
    out, mutated = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=True, return_feat=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    want = state_dict_from_jax({"params": variables["params"],
                                "batch_stats": mutated["batch_stats"]},
                               "rangenet", 53)
    model = _no_dropout(_port_model("rangenet", variables, layers=53))
    model.train()
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2),
                    return_feat=True)
    np.testing.assert_allclose(got["logits"].permute(0, 2, 3, 1).numpy(),
                               np.asarray(out["logits"]), rtol=0, atol=1e-4)
    stats = {k: w for k, w in want.items()
             if k.endswith(("running_mean", "running_var"))}
    assert len(stats) == 2 * (1 + 5 + 2 * 23 + 3 * 5 + 1)
    state = model.state_dict()
    for k, w in stats.items():
        np.testing.assert_allclose(
            state[k].numpy(), w.numpy(), rtol=1e-5,
            atol=1e-5 if k.endswith("running_mean") else 0, err_msg=k)


def test_serving_records_the_encoder_and_decoder_spans():
    """Each served batch records ``model.encoder`` then ``model.decoder``,
    once each, as children of its ``serve.backbone``."""
    cfg = preset("tiny")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, net_type="rangenet", layers=21))
    assert (cfg.sensor.proj_h, cfg.sensor.proj_w) == (16, 64)
    model = build_model(cfg, device="cpu")
    scans = [pad_points(synthetic_scan(np.random.default_rng(s), 1500, 8,
                                       cfg.sensor)["points"], 2048)
             for s in range(2)]
    points = torch.from_numpy(np.stack([p for p, _ in scans]))
    valid = torch.from_numpy(np.stack([v for _, v in scans]))
    infer = make_inference_fn(model, cfg)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            infer(points, valid)
    spans = traced_spans()
    backbones = [s for s in spans if s["name"] == "serve.backbone"]
    assert len(backbones) == 2
    for parent in backbones:
        children = [s["name"] for s in spans if s["parent"] == parent["id"]]
        assert children == ["model.encoder", "model.decoder"]
    enc, dec = ([s for s in spans if s["name"] == n]
                for n in ("model.encoder", "model.decoder"))
    assert len(enc) == len(dec) == 2
    for e, d in zip(enc, dec):
        assert e["end_ns"] <= d["start_ns"]
