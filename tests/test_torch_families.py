"""The port's other model families (coarse3d_tpu_torch.models: RangeNet,
SqueezeSegV3, SalsaNext's s2d stems and classification mode, the extra
blocks) vs the JAX package's, on the CPU in float32.

JAX-initialised variables (BN statistics and affines randomised) are
carried across by ``state_dict_from_jax`` and loaded strictly. RangeNet's
and SqueezeSegV3's widths are fixed (32 .. 1024 channels), so the tests
shrink the image (16x64 or 8x64, B=2) and use ``layers=21`` for forwards.

Tolerances: logits / probs within atol 1e-4, the embedding within 1e-5;
BatchNorm running statistics after one train-mode forward within rtol 1e-5
(the mean also atol 1e-5); extras within 1e-5; ``unfold3x3`` exact; one
training step's losses within 1e-4 relative and its prototype memory within
1e-5, as ``tests/test_torch_train_step.py`` holds SalsaNext's.

RangeNet's and SqueezeSegV3's dropout rates are constants inside the
models, so ``model.dropout_rate=0`` does not silence them: the train-mode
tests replace ``flax.linen.Dropout`` by the identity for the JAX side (a
monkeypatch; nothing in the package changes) and set ``p = 0`` on the
port's ``Dropout2d`` modules.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coarse3d_tpu.configs import preset as jax_preset
from coarse3d_tpu.data.synthetic import synthetic_batch as jax_batch
from coarse3d_tpu.models import SalsaNext as JaxSalsaNext
from coarse3d_tpu.models import blocks as jblocks
from coarse3d_tpu.models.rangenet import RangeNet as JaxRangeNet
from coarse3d_tpu.models.squeezesegv3 import SqueezeSegV3 as JaxSqueezeSegV3
from coarse3d_tpu.models.squeezesegv3 import unfold3x3 as jax_unfold3x3
from coarse3d_tpu.tools.convert_torch_ckpt import export_state_dict
from coarse3d_tpu.train import setup as jsetup
from coarse3d_tpu.train import step as jstep
from coarse3d_tpu_torch.configs import preset
from coarse3d_tpu_torch.models import blocks as tblocks
from coarse3d_tpu_torch.models.blocks import Dropout2d
from coarse3d_tpu_torch.models.rangenet import RangeNet
from coarse3d_tpu_torch.models.salsanext import SalsaNext
from coarse3d_tpu_torch.models.squeezesegv3 import SqueezeSegV3, unfold3x3
from coarse3d_tpu_torch.tools import train as train_cli
from coarse3d_tpu_torch.tools.convert_jax_params import (
    state_dict_from_jax,
    train_state_from_jax,
)
from coarse3d_tpu_torch.train import setup as tsetup
from coarse3d_tpu_torch.train import step as tstep
from tests.test_torch_salsanext import jax_variables
from tests.test_torch_train_step import _jax_noise

C, PROJ = 8, 32

JAX_NETS = {"rangenet": JaxRangeNet, "squeezesegv3": JaxSqueezeSegV3}
PORT_NETS = {"rangenet": RangeNet, "squeezesegv3": SqueezeSegV3}


def _jax_model(net, layers=21, **kw):
    return JAX_NETS[net](n_classes=C, layers=layers, proj_dim=PROJ,
                         dtype=jnp.float32, **kw)


def _port_model(net, variables, layers=21, **kw):
    model = PORT_NETS[net](n_classes=C, layers=layers, proj_dim=PROJ,
                           compute_dtype=torch.float32, **kw)
    model.load_state_dict(state_dict_from_jax(variables, net, layers),
                          strict=True)
    return model.eval()


def _identity_dropout(monkeypatch):
    """flax.linen.Dropout -> identity, for the JAX models whose rates are
    constants in ``__call__``."""
    monkeypatch.setattr(nn, "Dropout", lambda *a, **kw: (lambda v: v))


def _no_dropout(model):
    for mod in model.modules():
        if isinstance(mod, Dropout2d):
            mod.p = 0.0
    return model


# -- weights across ----------------------------------------------------------

@pytest.mark.parametrize("net", ["rangenet", "squeezesegv3"])
@pytest.mark.parametrize("layers", [21, 53])
def test_state_dict_equals_export_state_dict(net, layers):
    jmodel = _jax_model(net, layers)
    variables = jax_variables(jmodel, (1, 8, 64, 5), seed=layers)
    want, missing = export_state_dict(variables, net, layers)
    assert not missing
    got = state_dict_from_jax(variables, net, layers)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    model = PORT_NETS[net](n_classes=C, layers=layers, proj_dim=PROJ)
    model.load_state_dict(got, strict=True)
    # exactly the port model's parameters and buffers
    assert set(got) == {k for k in model.state_dict()
                        if not k.endswith("num_batches_tracked")}


def test_transposed_conv_kernel_is_flipped():
    """A Flax ConvTranspose kernel is the PyTorch one transposed AND flipped
    in space: one UpConvBN against one DecoderStage's upconv + bn."""
    from coarse3d_tpu.models.rangenet import UpConvBN
    from coarse3d_tpu_torch.models.rangenet import DecoderStage, conv_bn

    x = np.random.default_rng(0).normal(size=(2, 4, 8, 16)).astype(np.float32)
    jmod = UpConvBN(8, dtype=jnp.float32)
    variables = jax.device_get(jmod.init(jax.random.key(0), jnp.asarray(x),
                                         False))
    kernel = np.asarray(variables["params"]["ConvTranspose_0"]["kernel"])
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), False))
    stage = DecoderStage(16, 8).eval()
    with torch.no_grad():
        stage.upconv.weight.copy_(torch.from_numpy(
            kernel[::-1, ::-1].transpose(2, 3, 0, 1).copy()))
        stage.upconv.bias.copy_(torch.from_numpy(np.asarray(
            variables["params"]["ConvTranspose_0"]["bias"])))
        got = conv_bn(torch.from_numpy(x).permute(0, 3, 1, 2), stage.upconv,
                      stage.bn)
    assert got.shape == (2, 8, 4, 16)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-5)


# -- forward parity ----------------------------------------------------------

def _compare_forward(want, got):
    for k, atol in (("logits", 1e-4), ("probs", 1e-4), ("embedding", 1e-5)):
        g = got[k].permute(0, 2, 3, 1).numpy()
        wk = np.asarray(want[k])
        assert g.shape == wk.shape, k
        print(f"{k} max abs err {np.abs(g - wk).max():.3e} "
              f"(max |value| {np.abs(wk).max():.3e})")
        np.testing.assert_allclose(g, wk, rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("net,kw,shape", [
    ("rangenet", {}, (2, 16, 64)),
    ("rangenet", {"pad_w": 24}, (2, 8, 40)),      # POSS-like: 40 + 24 = 64
    ("squeezesegv3", {}, (2, 16, 64)),
])
def test_family_forward_matches_jax(net, kw, shape):
    b, h, w = shape
    jmodel = _jax_model(net, **kw)
    variables = jax_variables(jmodel, (b, h, w, 5), seed=3)
    x = np.random.default_rng(7).normal(size=(b, h, w, 5)).astype(np.float32)
    want = jmodel.apply(variables, jnp.asarray(x), train=False,
                        return_feat=True)
    with torch.no_grad():
        got = _port_model(net, variables, **kw)(
            torch.from_numpy(x).permute(0, 3, 1, 2), return_feat=True)
    _compare_forward(want, got)


@pytest.mark.parametrize("factors,shape", [((2, 2), (2, 32, 64)),
                                           ((1, 2), (2, 16, 64))])
def test_s2d_stem_forward_matches_jax(factors, shape):
    b, h, w = shape
    jmodel = JaxSalsaNext(n_classes=C, proj_dim=PROJ, dtype=jnp.float32,
                          s2d_factors=factors)
    variables = jax_variables(jmodel, (b, h, w, 5), seed=5)
    assert "cls_head_s2d" in variables["params"]
    x = np.random.default_rng(8).normal(size=(b, h, w, 5)).astype(np.float32)
    want = jmodel.apply(variables, jnp.asarray(x), train=False,
                        return_feat=True)
    model = SalsaNext(n_classes=C, proj_dim=PROJ, s2d_factors=factors,
                      compute_dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2),
                           return_feat=True)
    _compare_forward(want, got)


def test_classification_mode_matches_jax():
    jmodel = JaxSalsaNext(n_classes=C, proj_dim=PROJ, dtype=jnp.float32,
                          classification=True)
    variables = jax_variables(jmodel, (2, 16, 64, 5), seed=6)
    x = np.random.default_rng(9).normal(size=(2, 16, 64, 5)).astype(
        np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x),
                                   train=False)["class_logits"])
    model = SalsaNext(n_classes=C, proj_dim=PROJ, classification=True,
                      compute_dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert set(got) == {"class_logits"} and want.shape == (2, 1000)
    np.testing.assert_allclose(got["class_logits"].numpy(), want, rtol=0,
                               atol=1e-5)


# -- train-mode forward ------------------------------------------------------

@pytest.mark.parametrize("net", ["rangenet", "squeezesegv3"])
def test_train_forward_running_stats_match_flax(net, monkeypatch):
    """One train-mode forward folds the batch statistics into the running
    ones as Flax does, with each family's momenta (0.01 in the darknet
    blocks, 0.1 in the SAC blocks and the projector)."""
    _identity_dropout(monkeypatch)
    jmodel = _jax_model(net)
    variables = jax_variables(jmodel, (2, 16, 64, 5), seed=4)
    x = np.random.default_rng(11).normal(size=(2, 16, 64, 5)).astype(
        np.float32)
    _, mutated = jmodel.apply(variables, jnp.asarray(x), train=True,
                              return_feat=True, mutable=["batch_stats"])
    want = state_dict_from_jax({"params": variables["params"],
                                "batch_stats": mutated["batch_stats"]}, net)
    model = _no_dropout(_port_model(net, variables)).train()
    with torch.no_grad():
        model(torch.from_numpy(x).permute(0, 3, 1, 2), return_feat=True)
    got = model.state_dict()
    before = state_dict_from_jax(variables, net)
    moved = 0
    for k, w in want.items():
        kind = k.rsplit(".", 1)[1]
        if kind not in ("running_mean", "running_var"):
            continue
        moved += not torch.equal(w, before[k])
        np.testing.assert_allclose(
            got[k].numpy(), w.numpy(), rtol=1e-5,
            atol=1e-5 if kind == "running_mean" else 0, err_msg=k)
    assert moved > 20


# -- unfold and the extra blocks ---------------------------------------------

def test_unfold3x3_matches_jax():
    x = np.random.default_rng(2).normal(size=(2, 5, 7, 3)).astype(np.float32)
    want = np.asarray(jax_unfold3x3(jnp.asarray(x)))
    got = unfold3x3(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def _carry(module, variables, names):
    """Load Flax ``variables`` into a port extra block: ``names`` maps each
    Flax layer path to the port's attribute path."""
    sd = {}
    for flax_path, port in names.items():
        node = variables["params"]
        for part in flax_path.split("/"):
            node = node[part]
        if "kernel" in node:
            k = np.asarray(node["kernel"])
            sd[f"{port}.weight"] = torch.from_numpy(
                (k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T).copy())
            sd[f"{port}.bias"] = torch.from_numpy(np.asarray(node["bias"]))
        else:
            stats = variables["batch_stats"]
            for part in flax_path.split("/"):
                stats = stats[part]
            sd[f"{port}.weight"] = torch.from_numpy(np.asarray(node["scale"]))
            sd[f"{port}.bias"] = torch.from_numpy(np.asarray(node["bias"]))
            sd[f"{port}.running_mean"] = torch.from_numpy(
                np.asarray(stats["mean"]))
            sd[f"{port}.running_var"] = torch.from_numpy(
                np.asarray(stats["var"]))
    missing, unexpected = module.load_state_dict(sd, strict=False)
    assert not unexpected and all(
        k.endswith("num_batches_tracked") for k in missing), (missing,
                                                              unexpected)
    return module.eval()


CIN = 16
EXTRAS = {
    "se": (lambda: jblocks.SEBlock(4, dtype=jnp.float32),
           lambda: tblocks.SEBlock(CIN, 4),
           {"Dense_0": "fc1", "Dense_1": "fc2"}, ()),
    "classifier": (lambda: jblocks.ClassifierHead(10),
                   lambda: tblocks.ClassifierHead(CIN, 10),
                   {"Dense_0": "fc"}, ()),
    "conv_upsample": (lambda: jblocks.ConvUpSample(6, dtype=jnp.float32),
                      lambda: tblocks.ConvUpSample(CIN, 6),
                      {"ConvActBN_0/Conv_0": "conv",
                       "ConvActBN_0/BatchNorm_0": "bn"}, (False,)),
    "projection_v2": (lambda: jblocks.ProjectionHeadV2(6),
                      lambda: tblocks.ProjectionHeadV2(CIN, 6),
                      {"Conv_0": "proj.0", "Conv_1": "proj.2"}, ()),
    "projection_v3": (lambda: jblocks.ProjectionHeadV3(6),
                      lambda: tblocks.ProjectionHeadV3(CIN, 6),
                      {"Conv_0": "proj.0", "Conv_1": "proj.2"}, ()),
    "projection_v4": (lambda: jblocks.ProjectionHeadV4(6),
                      lambda: tblocks.ProjectionHeadV4(CIN, 6),
                      {"Conv_0": "proj"}, ()),
    "cs_attention_stride1": (
        lambda: jblocks.CSAttention(6, stride=1, dtype=jnp.float32),
        lambda: tblocks.CSAttention(CIN, 6, stride=1),
        {"Conv_0": "value.0", "Conv_1": "value.1", "Conv_2": "attention.0",
         "Conv_3": "attention.1"}, ()),
    "cs_attention_stride2": (
        lambda: jblocks.CSAttention(6, stride=2, scale=0.5,
                                    dtype=jnp.float32),
        lambda: tblocks.CSAttention(CIN, 6, stride=2, scale=0.5),
        {"Conv_0": "value.0", "Conv_1": "value.1", "Conv_2": "attention.0",
         "Conv_3": "attention.1"}, ()),
}


@pytest.mark.parametrize("name", sorted(EXTRAS))
def test_extra_block_matches_jax(name):
    make_jax, make_port, names, args = EXTRAS[name]
    # an even and an odd width: "SAME" at stride 2 pads them differently
    for shape in ((2, 8, 12, CIN), (2, 7, 9, CIN)):
        x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
        jmod = make_jax()
        variables = jax.device_get(
            jmod.init(jax.random.key(1), jnp.asarray(x), *args))
        want = np.asarray(jmod.apply(variables, jnp.asarray(x), *args))
        with torch.no_grad():
            got = _carry(make_port(), variables, names)(
                torch.from_numpy(x).permute(0, 3, 1, 2))
        if got.ndim == 4:
            got = got.permute(0, 2, 3, 1)
        assert tuple(got.shape) == want.shape, (name, shape)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5,
                                   err_msg=f"{name} {shape}")


def test_rectangular_pixel_shuffle_matches_jax():
    x = np.random.default_rng(3).normal(size=(2, 4, 6, 18)).astype(np.float32)
    for r, rw in ((1, 2), (3, 2), (3, 3), (2, 1)):
        want = np.asarray(jblocks.pixel_shuffle(jnp.asarray(x), r, rw))
        got = tblocks.pixel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2),
                                    r, rw)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


# -- the training step -------------------------------------------------------

RATIO = 0.3


def _family_cfg(make_preset, net):
    cfg = make_preset("tiny")
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, net_type=net, layers=21, dropout_rate=0.0))


def _run_steps(net, plan):
    """``plan`` steps (with_contrast flags) on both sides, the port loading
    JAX's carried state before each, as tests/test_torch_train_step.py."""
    cfg_t, cfg_j = _family_cfg(preset, net), _family_cfg(jax_preset, net)
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
    host = jax_batch(np.random.default_rng(0), cfg_j, 2, n_points=3000,
                     weak_ratio=0.01)
    jb = {k: jnp.asarray(v) for k, v in host.items()}
    tb = tstep.batch_to_device(host, torch.device("cpu"))
    b, h, w = host["train_label"].shape
    alpha = jsetup.build_alpha(cfg_j)
    record = []
    with pytest.MonkeyPatch.context() as mp:
        _identity_dropout(mp)
        jstate = jsetup.build_state(cfg_j, jax.random.key(0),
                                    steps_per_epoch=1, batch_size=b)
        tstate = tsetup.build_state(cfg_t, device="cpu", steps_per_epoch=1)
        _no_dropout(tstate.model)
        for wc in plan:
            tstate.load(train_state_from_jax(jax.device_get(jstate), net, 21))
            noise = _jax_noise(jstate.rng, cfg_j, b, h, w)
            jstate, jm = jax.jit(jstep.make_train_step(
                cfg_j, alpha, with_contrast=wc))(jstate, jb, RATIO)
            tstate, tm = tstep.make_train_step(
                cfg_t, alpha, with_contrast=wc)(tstate, tb, RATIO,
                                                noise if wc else None)
            record.append({"jm": jax.device_get(jm), "tm": tm,
                           "jax_protos": np.asarray(jstate.prototypes),
                           "port_protos": tstate.prototypes.numpy()})
    return record


@pytest.fixture(scope="module")
def rangenet_steps():
    return _run_steps("rangenet", (False, True))


def _check_step(rec):
    want, got = rec["jm"]["losses"], rec["tm"]["losses"]
    assert set(got) == set(want)
    for k in want:
        print(f"{k}: port {float(got[k])} jax {float(want[k])}")
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   atol=0, err_msg=k)
    np.testing.assert_array_equal(rec["tm"]["confusion"].numpy(),
                                  np.asarray(rec["jm"]["confusion"]))
    np.testing.assert_allclose(rec["port_protos"], rec["jax_protos"], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("i,with_contrast", [(0, False), (1, True)])
def test_rangenet_train_step_matches_jax(rangenet_steps, i, with_contrast):
    rec = rangenet_steps[i]
    assert ("contrast" in rec["tm"]["losses"]) == with_contrast
    _check_step(rec)
    if with_contrast:
        np.testing.assert_allclose(
            np.linalg.norm(rec["port_protos"], axis=-1), 1.0, rtol=1e-5)
        for k, v in rec["jm"]["diag"].items():
            np.testing.assert_allclose(float(rec["tm"]["diag"][k]), float(v),
                                       rtol=0, atol=1e-5, err_msg=k)


def test_squeezesegv3_warmup_step_matches_jax():
    _check_step(_run_steps("squeezesegv3", (False,))[0])


# -- build_model and the CLIs ------------------------------------------------

def _with_model(cfg, **kw):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **kw))


@pytest.mark.parametrize("net,layers", [
    ("salsanext", 21), ("rangenet", 21), ("rangenet", 53),
    ("squeezesegv3", 21), ("squeezesegv3", 53)])
def test_build_model_dispatch(net, layers):
    cfg = _with_model(preset("tiny"), net_type=net, layers=layers)
    model = tsetup.build_model(cfg, device="cpu", seed=1)
    jmodel = jsetup.build_model(_with_model(jax_preset("tiny"), net_type=net,
                                            layers=layers))
    assert model.__class__.__name__ == jmodel.__class__.__name__
    assert not model.training
    if net != "salsanext":
        assert model.layers == layers
        # every weight comes from the seed, transposed convs included
        again = tsetup.build_model(cfg, device="cpu", seed=1)
        for (k, a), b in zip(model.state_dict().items(),
                             again.state_dict().values()):
            assert torch.equal(a, b), k


def test_build_model_stems_padding_and_errors():
    tiny = preset("tiny")
    assert tsetup.build_model(_with_model(tiny, stem="s2d_w"),
                              device="cpu").s2d_factors == (1, 2)
    poss = preset("poss")
    assert tsetup.build_model(_with_model(poss, net_type="rangenet"),
                              device="cpu").pad_w == 24
    assert tsetup.build_model(_with_model(poss, net_type="squeezesegv3"),
                              device="cpu") is not None
    # the JAX package's errors, word for word
    for bad in (_with_model(tiny, stem="s2d"),          # 16 rows / 2 = 8
                _with_model(poss, stem="s2d"),
                _with_model(tiny, stem="nope"),
                _with_model(tiny, net_type="nope")):
        jbad = _with_model(jax_preset("tiny" if bad.data.dataset != (
            "semantic_poss") else "poss"), net_type=bad.model.net_type,
            stem=bad.model.stem)
        with pytest.raises(ValueError) as want:
            jsetup.build_model(jbad)
        with pytest.raises(ValueError) as got:
            tsetup.build_model(bad, device="cpu")
        assert str(got.value) == str(want.value)


def test_pretrained_load_follows_jax_for_other_families():
    """load_pretrained_params is filtered by name and shape for any family;
    SalsaNext's encoder prefixes match nothing of a RangeNet, in both
    packages."""
    from coarse3d_tpu.models.salsanext import ENCODER_PREFIXES as JAX_ENC
    from coarse3d_tpu.train.checkpoint import (
        load_pretrained_params as jax_load,
    )
    from coarse3d_tpu_torch.models.salsanext import ENCODER_PREFIXES
    from coarse3d_tpu_torch.train.checkpoint import load_pretrained_params

    cfg = _family_cfg(preset, "rangenet")
    state = tsetup.build_state(cfg, device="cpu", seed=0, steps_per_epoch=1)
    other = tsetup.build_model(cfg, device="cpu", seed=9).state_dict()
    _, copied = load_pretrained_params(state, other)
    assert copied == len(other)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, other[k]), k
    _, none = load_pretrained_params(state, other,
                                     only_prefixes=ENCODER_PREFIXES)
    jstate = jsetup.build_state(_family_cfg(jax_preset, "rangenet"),
                                jax.random.key(0), steps_per_epoch=1,
                                batch_size=1)
    _, jnone = jax_load(jstate, jax.device_get(jstate.params),
                        only_prefixes=JAX_ENC)
    assert none == jnone == 0


@pytest.mark.parametrize("extra", [
    ["--set", "model.net_type=rangenet"],
    ["--stem", "s2d_w"],
])
def test_train_cli_other_families(extra, tmp_path):
    trainer = train_cli.main([
        "--preset", "tiny", "--device", "cpu", "--num_workers", "1",
        "--synthetic", "4", "--synthetic_points", "1500", "--batch_size",
        "2", "--epochs", "1", "--save_path", str(tmp_path / "run")] + extra)
    last = trainer.history[-1]
    assert last["mode"] == "Validation" and np.isfinite(last["3DIOU"])
    assert all(np.isfinite(v) for h in trainer.history
               for v in h["loss"].values())
    want = "RangeNet" if "model.net_type=rangenet" in extra else "SalsaNext"
    assert trainer.state.model.__class__.__name__ == want

    # tools/infer.py serves the run with the same model flags
    from coarse3d_tpu_torch.data.synthetic import SyntheticDataset
    from coarse3d_tpu_torch.tools import infer as infer_cli

    scan = tmp_path / "000000.bin"
    SyntheticDataset(1, 1500, 8, trainer.cfg.sensor).load(0)["points"].tofile(
        scan)
    model_flags = (["--set", "model.stem=s2d_w"] if "--stem" in extra
                   else extra)
    infer_cli.main(["--preset", "tiny", "--device", "cpu", "--scans",
                    str(scan), "--out", str(tmp_path / "preds"), "--run_dir",
                    str(tmp_path / "run")] + model_flags)
    pred = np.fromfile(tmp_path / "preds" / "000000.label", np.int32)
    assert pred.shape == (1500,)
