"""Port Sinkhorn and prototype memory (coarse3d_tpu_torch.ops.sinkhorn,
.models.prototypes, .ops.proto_update) vs the JAX package's, on the CPU at
the tiny size (8 classes, K=4, D=32, M=128), with the JAX package's Gumbel
noise handed to the port. Tolerances:

- ``masked_sinkhorn``: onehot and index exactly equal on the same noise;
- ``update_prototypes`` (the twin path on a CPU tensor) vs JAX
  ``update_prototypes``: atol 1e-5 (float32 sums in another order);
- ``proto_tail_reference`` (K3's twin) vs ``fused_proto_tail`` in interpret
  mode: atol 1e-5, at momentum 0.9 and 0.0;
- empty-class and ignore-class rows equal l2(memory) within 1e-6;
- ``prototype_diagnostics`` within 1e-6; ``prototype_similarity`` within
  1e-6 (1e-5 after its class LayerNorm).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coarse3d_tpu.configs.config import ContrastConfig as JaxContrastConfig
from coarse3d_tpu.models import prototypes as jproto
from coarse3d_tpu.ops.gather import gather_class_indices as jgather_idx
from coarse3d_tpu.ops.pallas.proto_update import fused_proto_tail
from coarse3d_tpu.ops.sinkhorn import masked_sinkhorn as jsinkhorn
from coarse3d_tpu_torch.configs.config import ContrastConfig
from coarse3d_tpu_torch.models import prototypes as tproto
from coarse3d_tpu_torch.ops import proto_update as k3
from coarse3d_tpu_torch.ops.sinkhorn import masked_sinkhorn

C, K, D, M = 8, 4, 32, 128
B, H, W = 2, 16, 64


def _t(a):
    return torch.from_numpy(np.array(a))


def proto_gumbel(key, c=C, m=M, k=K) -> np.ndarray:
    """The (C, M, K) noise JAX's update_prototypes draws from ``key``."""
    return np.stack([np.asarray(jax.random.gumbel(r, (m, k), jnp.float32))
                     for r in jax.random.split(key, c)])


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    protos = rng.normal(size=(C, K, D)).astype(np.float32)
    emb = rng.normal(size=(B, H, W, D)).astype(np.float32)
    lbl = rng.integers(0, C, (B, H, W)).astype(np.int32)
    lbl[lbl == 3] = 1                                # class 3 absent
    lbl[0, :8] = 2                                   # class 2 over budget
    msk = rng.random((B, H, W)) < 0.5
    msk[0, :8] = True
    return dict(protos=protos, emb=emb, lbl=lbl, msk=msk)


def _cfgs(momentum):
    kw = dict(sub_proto_size=K, proj_dim=D, max_pixels_per_class=M,
              proto_momentum=momentum)
    return JaxContrastConfig(**kw), ContrastConfig(**kw)


@pytest.mark.parametrize("n_valid", [0, 1, 37, M])
def test_masked_sinkhorn_exact(n_valid):
    rng = np.random.default_rng(n_valid)
    sim = rng.uniform(-1, 1, (M, K)).astype(np.float32)
    valid = np.arange(M) < n_valid
    valid = valid[rng.permutation(M)]
    key = jax.random.key(n_valid + 1)
    want_oh, want_idx = jsinkhorn(jnp.asarray(sim), jnp.asarray(valid), key)
    gumbel = np.asarray(jax.random.gumbel(key, (M, K), jnp.float32))
    got_oh, got_idx = masked_sinkhorn(_t(sim), _t(valid), _t(gumbel))
    np.testing.assert_array_equal(got_oh.numpy(), np.asarray(want_oh))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))


def test_prototype_similarity(data):
    want = jproto.prototype_similarity(jnp.asarray(data["emb"]),
                                       jnp.asarray(data["protos"]))
    got = tproto.prototype_similarity(_t(data["emb"]), _t(data["protos"]))
    # feat and sim within 1e-6; nearest within 1e-5: its LayerNorm over 8
    # class maxima divides float noise by their small spread
    for g, w, atol in zip(got, want, (1e-6, 1e-6, 1e-5)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("momentum", [0.9, 0.999])
def test_update_prototypes_matches_jax(data, momentum):
    jcfg, tcfg = _cfgs(momentum)
    key = jax.random.key(11)
    want = np.asarray(jproto.update_prototypes(
        jnp.asarray(data["protos"]), jnp.asarray(data["emb"]),
        jnp.asarray(data["lbl"]), jnp.asarray(data["msk"]), key, jcfg))
    k3.proto_tail.launches = 0
    got = tproto.update_prototypes(
        _t(data["protos"]), _t(data["emb"]), _t(data["lbl"]), _t(data["msk"]),
        _t(proto_gumbel(key)), tcfg).numpy()
    assert k3.proto_tail.launches == 0            # a CPU tensor: the twin
    err = np.abs(got - want).max()
    print(f"update_prototypes momentum {momentum}: max abs err {err:.3e}")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    l2 = np.asarray(jproto.l2_normalize(jnp.asarray(data["protos"])))
    for c in (0, 3):                               # ignore class, empty class
        np.testing.assert_allclose(got[c], l2[c], rtol=0, atol=1e-6)


def test_update_prototypes_reads_an_nchw_view(data):
    """The step hands the model's (B, D, H, W) output as a permuted view;
    the gather reads it in place with the same result."""
    _, tcfg = _cfgs(0.9)
    g = _t(proto_gumbel(jax.random.key(2)))
    args = (_t(data["lbl"]), _t(data["msk"]), g, tcfg)
    dense = tproto.update_prototypes(_t(data["protos"]), _t(data["emb"]),
                                     *args)
    view = _t(data["emb"]).permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert not view.is_contiguous()
    np.testing.assert_array_equal(
        tproto.update_prototypes(_t(data["protos"]), view, *args).numpy(),
        dense.numpy())


def _tail_inputs(data, key):
    lbl = jnp.asarray(data["lbl"]).reshape(-1)
    valid = jnp.asarray(data["msk"]).reshape(-1) & (lbl != 0)
    idx, vmask = jgather_idx(lbl, valid, C, M)
    rows = np.asarray(jnp.asarray(data["emb"]).reshape(-1, D)[idx])
    protos_n = np.asarray(jproto.l2_normalize(jnp.asarray(data["protos"])))
    return rows, np.asarray(vmask), protos_n, proto_gumbel(key)


@pytest.mark.parametrize("momentum", [0.9, 0.0])
def test_proto_tail_twin_matches_pallas_interpret(data, momentum):
    jcfg, _ = _cfgs(momentum)
    rows, vmask, protos_n, gumbel = _tail_inputs(data, jax.random.key(5))
    want = np.asarray(fused_proto_tail(
        jnp.asarray(rows), jnp.asarray(vmask), jnp.asarray(protos_n),
        jnp.asarray(gumbel), jcfg, ignore_cls=0, interpret=True))
    got = k3.proto_tail_reference(
        _t(rows), _t(vmask), _t(protos_n), _t(gumbel), momentum=momentum,
        ignore_cls=0).numpy()
    err = np.abs(got - want).max()
    print(f"proto_tail twin vs Pallas (interpret) momentum {momentum}: "
          f"max abs err {err:.3e}")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the CPU wrapper is the twin, launch-free
    np.testing.assert_array_equal(
        k3.proto_tail(_t(rows), _t(vmask), _t(protos_n), _t(gumbel),
                      momentum=momentum, ignore_cls=0).numpy(), got)
    for c in (0, 3):
        np.testing.assert_allclose(got[c], protos_n[c] / np.linalg.norm(
            protos_n[c], axis=-1, keepdims=True), rtol=0, atol=1e-6)


def test_proto_tail_checks_its_inputs(data):
    rows, vmask, protos_n, gumbel = _tail_inputs(data, jax.random.key(6))
    with pytest.raises(TypeError, match="bool"):
        k3.proto_tail(_t(rows), _t(vmask).float(), _t(protos_n), _t(gumbel),
                      momentum=0.9)
    with pytest.raises(ValueError, match="gumbel"):
        k3.proto_tail(_t(rows), _t(vmask), _t(protos_n), _t(gumbel)[:, 1:],
                      momentum=0.9)
    with pytest.raises(TypeError, match="float32"):
        k3.proto_tail(_t(rows).double(), _t(vmask), _t(protos_n), _t(gumbel),
                      momentum=0.9)
    # shared memory of both passes at KITTI size fits one H100 block
    assert max(k3.smem_bytes(20, 2048, 20, 256)) <= k3.SMEM_LIMIT


def test_prototype_diagnostics(data):
    old = data["protos"]
    new = np.asarray(jproto.l2_normalize(jnp.asarray(old) + 0.1))
    want = jproto.prototype_diagnostics(jnp.asarray(old), jnp.asarray(new))
    got = tproto.prototype_diagnostics(_t(old), _t(new))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_ddp_parity_update_raises():
    with pytest.raises(NotImplementedError, match="item 15"):
        tproto.update_prototypes_ddp_parity()
