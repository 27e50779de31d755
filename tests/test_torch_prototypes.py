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
  1e-6 (1e-5 after its class LayerNorm);
- ``_k3_schedule``, a plain mirror of K3's schedule on the card (row tiles,
  class-aligned chunks, cluster slices, loops bounded by the last valid
  slot, the contraction by assignment groups), vs ``proto_tail_reference``:
  atol 1e-6 (the same arithmetic, sums cut in other places).
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



@pytest.mark.parametrize("name", ["kitti", "poss", "nuscenes"])
def test_proto_tail_smem_fits_every_preset(name):
    from coarse3d_tpu_torch.configs import preset

    cfg = preset(name)
    c, k = cfg.data.n_classes, cfg.contrast.sub_proto_size
    m, d = cfg.contrast.max_pixels_per_class, cfg.contrast.proj_dim
    row, cls = k3.smem_bytes(c, m, k, d)
    print(f"{name}: C={c} M={m} K={k} D={d}: row pass {row} B, class pass "
          f"{cls} B of {k3.SMEM_LIMIT}")
    assert max(row, cls) <= k3.SMEM_LIMIT
    # two row-pass blocks share one SM's 228 KB (1 KB reserved per block)
    assert 2 * (row + 1024) <= 233472


@pytest.mark.parametrize("shape,match", [
    ((2, 64, 4, 1024), "shared memory"),   # the row pass's tile of rows
    ((2, 64, 4, 48), "multiple of 32"),
    ((33, 64, 4, 32), "C <= 32"),
])
def test_proto_tail_kernel_refuses_what_it_cannot_take(shape, match):
    c, m, k, d = shape
    args = (torch.zeros(c, m, d), torch.zeros(c, m, dtype=torch.bool),
            torch.zeros(c, k, d), torch.zeros(c, m, k))
    with pytest.raises(ValueError, match=match):
        k3._kernel_buffers(*args)


def _l2n(x):
    return x / torch.clamp_min(torch.sqrt((x * x).sum(-1, keepdim=True)), 1e-12)


def _ln(x, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(((x - mu) ** 2).mean(-1, keepdim=True) + eps)


def _k3_schedule(feat_rows, valid, protos_n, gumbel, momentum, ignore_cls=0):
    """K3's schedule on the card, in plain PyTorch (csrc/proto_update.cu).

    Row pass: tiles of ROWS_PER_TILE rows of one class, skipped when they
    hold no valid row, each against one chunk of whole classes of the
    memory (at most PROTOS_PER_CHUNK columns, chunks as even as they go);
    the chunk's class maxima folded into the rows' C-vector and the
    own-class block kept. Class pass: the rows up to the last valid slot
    cut into CLUSTER slices; the agreement from the class maxima; max,
    total and each round's column sums combined slice by slice in rank
    order; the contraction summed per assignment group within each slice,
    then the slices' partial sums in rank order.
    """
    c, m, d = feat_rows.shape
    k = protos_n.shape[1]
    eps, iters, cl = k3.SINKHORN_EPS, k3.SINKHORN_ITERS, k3.CLUSTER
    featn = _l2n(_ln(feat_rows))
    near = torch.full((c, m, c), float("-inf"))
    simc = torch.zeros(c, m, k)
    agree = torch.zeros(c, m, dtype=torch.bool)
    most = max(1, min(c, k3.PROTOS_PER_CHUNK // k))
    per_chunk = -(-c // -(-c // most))     # chunks as even as they go
    for cls in range(c):
        for r0 in range(0, m, k3.ROWS_PER_TILE):
            rows = slice(r0, min(r0 + k3.ROWS_PER_TILE, m))
            if not bool(valid[cls, rows].any()):
                continue
            for q0 in range(0, c, per_chunk):
                nq = min(per_chunk, c - q0)
                sims = featn[cls, rows] @ protos_n[q0:q0 + nq].reshape(
                    nq * k, d).T
                near[cls, rows, q0:q0 + nq] = sims.reshape(-1, nq, k).amax(-1)
                if q0 <= cls < q0 + nq:
                    simc[cls, rows] = sims[:, (cls - q0) * k:(cls - q0 + 1) * k]
            pred = torch.argmax(_ln(near[cls, rows]), dim=-1)
            agree[cls, rows] = valid[cls, rows] & (pred == cls)

    out = torch.empty(c, k, d)
    for cls in range(c):
        v = valid[cls]
        if not bool(v.any()) or cls == ignore_cls:
            out[cls] = _l2n(protos_n[cls])
            continue
        nv = v.sum().float()
        n_act = int(torch.nonzero(v).max()) + 1
        per = -(-n_act // cl)
        cuts = [(min(r * per, n_act), min(r * per + per, n_act))
                for r in range(cl)]
        logit = torch.where(v[:, None], simc[cls] / eps, float("-inf"))
        lmax = max(float(logit[a:b].max()) for a, b in cuts if b > a)
        q = torch.where(v[:, None], torch.exp(logit - lmax), 0.0)
        total = torch.zeros(())
        for a, b in cuts:
            total = total + q[a:b].sum()
        q = q / torch.where(total > 0, total, 1.0)
        for _ in range(iters):
            col = torch.zeros(k)
            for a, b in cuts:
                col = col + q[a:b].sum(0)
            q = (q / torch.where(col > 0, col, 1.0)) / k
            rs = q.sum(-1, keepdim=True)
            q = torch.where(v[:, None], (q / torch.where(rs > 0, rs, 1.0)) / nv,
                            0.0)
        hard = torch.argmax(q * nv + gumbel[cls], dim=-1)
        w = v & agree[cls]
        f = torch.zeros(k, d)
        count = torch.zeros(k, dtype=torch.int64)
        for a, b in cuts:
            for kk in range(k):
                group = torch.nonzero(w[a:b] & (hard[a:b] == kk))[:, 0] + a
                f[kk] = f[kk] + featn[cls, group].sum(0)
                count[kk] += len(group)
        f = _l2n(f)
        new = torch.where((count > 0)[:, None],
                          momentum * protos_n[cls] + (1 - momentum) * f,
                          protos_n[cls])
        out[cls] = _l2n(new)
    return out


def _schedule_case(kind, seed=0):
    """(feat, valid, protos_n, gumbel): the tiny shape, or C=20, K=20,
    D=256 with the class counts 0 (ignore class and class 1), 1, M and
    random elsewhere as prefixes, or scattered (non-prefix) masks."""
    rng = np.random.default_rng(seed)
    c, m, k, d = (C, M, K, D) if kind == "tiny" else (20, 512, 20, 256)
    feat = rng.normal(size=(c, m, d)).astype(np.float32)
    protos = rng.normal(size=(c, k, d)).astype(np.float32)
    protos /= np.linalg.norm(protos, axis=-1, keepdims=True)
    u = np.maximum(rng.random((c, m, k)), 1e-30)
    gumbel = (-np.log(-np.log(u))).astype(np.float32)
    if kind == "scattered":
        valid = rng.random((c, m)) < rng.uniform(0.02, 0.9, (c, 1))
        valid[0] = valid[1] = False
        valid[3] = False
        valid[3, m - 5] = True          # one valid row, at the end
    else:
        counts = rng.integers(2, m, c)
        counts[0] = counts[1] = 0
        counts[2] = m
        counts[3] = 1
        valid = np.arange(m)[None, :] < counts[:, None]
    return (_t(feat), _t(valid), _t(protos), _t(gumbel))


@pytest.mark.parametrize("momentum", [0.9, 0.0])
@pytest.mark.parametrize("kind", ["tiny", "prefix", "scattered"])
def test_k3_schedule_matches_the_twin(kind, momentum):
    feat, valid, protos_n, gumbel = _schedule_case(kind)
    want = k3.proto_tail_reference(feat, valid, protos_n, gumbel,
                                   momentum=momentum, ignore_cls=0)
    got = _k3_schedule(feat, valid, protos_n, gumbel, momentum)
    err = float((got - want).abs().max())
    print(f"K3 schedule vs twin, {kind}, momentum {momentum}: max abs err "
          f"{err:.3e}")
    assert err <= 1e-6
    # the empty and ignore classes keep l2(memory)
    np.testing.assert_allclose(got[:2].numpy(), _l2n(protos_n[:2]).numpy(),
                               rtol=0, atol=1e-6)


def test_prototype_diagnostics(data):
    old = data["protos"]
    new = np.asarray(jproto.l2_normalize(jnp.asarray(old) + 0.1))
    want = jproto.prototype_diagnostics(jnp.asarray(old), jnp.asarray(new))
    got = tproto.prototype_diagnostics(_t(old), _t(new))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_ddp_parity_update_raises(data):
    """Without the data mesh there are no ranks to average over (the mode
    itself is held against JAX in tests/test_torch_parallel.py)."""
    _, ccfg = _cfgs(0.9)
    with pytest.raises(ValueError, match="mesh"):
        tproto.update_prototypes_ddp_parity(
            _t(data["protos"]), _t(data["emb"]), _t(data["lbl"]),
            _t(data["msk"]), torch.zeros(C, M, K), ccfg, None)
