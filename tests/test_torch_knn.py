"""Port KNN post-processing (coarse3d_tpu_torch.ops.knn / knn_vote) vs the
JAX package, on the CPU: the plain twin of kernel K2 against JAX
``knn_postprocess`` and against the JAX Pallas vote kernel in interpret mode.
The CUDA kernel itself is held against the twin on the card by
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import coarse3d_tpu.ops.pallas.knn_vote as jkv
from coarse3d_tpu.ops import knn as jknn
from coarse3d_tpu_torch.ops import knn as tknn
from coarse3d_tpu_torch.ops.knn_vote import knn_vote, knn_vote_reference


def _setup(rng, b=2, p=3000, h=16, w=64, c=8):
    """The inputs of tests/test_pallas_knn.py:_setup."""
    proj_range = rng.uniform(1, 80, (b, h, w)).astype(np.float32)
    proj_range[rng.random((b, h, w)) < 0.3] = -1.0
    proj_argmax = rng.integers(0, c, (b, h, w)).astype(np.int32)
    px = rng.integers(0, w, (b, p)).astype(np.int32)
    py = rng.integers(0, h, (b, p)).astype(np.int32)
    prange = rng.uniform(1, 80, (b, p)).astype(np.float32)
    return proj_range, prange, proj_argmax, px, py, c


def _near_ranges(rng, proj_range, px, py):
    """Point ranges close to their pixel's range, so the vote sees
    neighbours inside the cutoff and not only the invalid class."""
    own = proj_range[np.arange(len(px))[:, None], py, px]
    return np.where(own > 0, own + rng.normal(0, 0.3, own.shape),
                    rng.uniform(1, 80, own.shape)).astype(np.float32)


def _both(proj_range, prange, proj_argmax, px, py, c, **kw):
    want = np.asarray(jknn.knn_postprocess(
        jnp.asarray(proj_range), jnp.asarray(prange), jnp.asarray(proj_argmax),
        jnp.asarray(px), jnp.asarray(py), n_classes=c, use_pallas=False, **kw))
    got = tknn.knn_postprocess(
        torch.from_numpy(proj_range), torch.from_numpy(prange),
        torch.from_numpy(proj_argmax), torch.from_numpy(px),
        torch.from_numpy(py), n_classes=c, **kw).numpy()
    return got, want


@pytest.mark.parametrize("near", [False, True])
@pytest.mark.parametrize("search,knn,cutoff", [
    (5, 5, 1.0), (3, 3, 1.0), (7, 9, 2.0), (5, 5, 0.0)])
def test_knn_postprocess_matches_jax(search, knn, cutoff, near):
    """Labels agree on >= 0.999 of points (XLA:CPU may contract |dr|*g+1
    into an FMA; the exact rate, printed, is expected to be 1.0)."""
    rng = np.random.default_rng(search * 10 + knn + int(near))
    proj_range, prange, proj_argmax, px, py, c = _setup(rng)
    if near:
        prange = _near_ranges(rng, proj_range, px, py)
    got, want = _both(proj_range, prange, proj_argmax, px, py, c,
                      knn=knn, search=search, sigma=1.0, cutoff=cutoff)
    assert got.dtype == np.int32 and got.shape == want.shape
    assert got.min() >= 1 and got.max() <= c - 1
    rate = (got == want).mean()
    print(f"knn agreement {rate}")
    assert rate >= 0.999, rate


def test_knn_twin_matches_pallas_vote(monkeypatch):
    """The twin (from the packed image) vs knn_vote_pallas (interpret mode)
    on the same pre-gathered windows: >= 0.999 agreement."""
    monkeypatch.setattr(jkv, "TILE", 512)
    rng = np.random.default_rng(21)
    proj_range, _, proj_argmax, px, py, c = _setup(rng)
    prange = _near_ranges(rng, proj_range, px, py)
    b, h, w = proj_range.shape
    rng_img = np.where(proj_range < 0, np.float32(3.0e38), proj_range)
    packed = np.asarray(jknn._pack(jnp.asarray(rng_img),
                                   jnp.asarray(proj_argmax)))
    padded = np.pad(packed, ((0, 0), (2, 2), (2, 2)))
    windows = np.stack([padded[:, dy:dy + h, dx:dx + w]
                        for dy in range(5) for dx in range(5)], -1)
    flat = py.astype(np.int64) * w + px
    neigh = np.take_along_axis(windows.reshape(b, h * w, 25),
                               flat[..., None], axis=1)
    want = np.asarray(jkv.knn_vote_pallas(
        jnp.asarray(neigh), jnp.asarray(prange), n_classes=c, knn=5,
        search=5, sigma=1.0, cutoff=1.0, interpret=True))

    got = knn_vote(torch.from_numpy(packed.copy()), torch.from_numpy(prange),
                   torch.from_numpy(px), torch.from_numpy(py), n_classes=c,
                   knn=5, search=5, sigma=1.0, cutoff=1.0).numpy()
    rate = (got == want).mean()
    print(f"pallas vote agreement {rate}")
    assert rate >= 0.999, rate


def test_pack_and_gauss_match_jax():
    """Mantissa pack / unpack and the inverted Gaussian: bit-exact."""
    rng = np.random.default_rng(2)
    vals = rng.uniform(0, 100, 1000).astype(np.float32)
    labels = rng.integers(0, 32, 1000).astype(np.int32)
    want = np.asarray(jknn._pack(jnp.asarray(vals), jnp.asarray(labels)))
    got = tknn._pack(torch.from_numpy(vals), torch.from_numpy(labels)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    r, lbl = tknn._unpack(torch.from_numpy(got))
    jr, jlbl = jknn._unpack(jnp.asarray(want))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(lbl.numpy(), labels)
    for size, sigma in [(3, 1.0), (5, 1.0), (7, 2.5)]:
        np.testing.assert_array_equal(tknn._inv_gaussian_kernel(size, sigma),
                                      jknn._inv_gaussian_kernel(size, sigma))


def test_knn_vote_wrapper_is_the_twin_on_cpu():
    rng = np.random.default_rng(4)
    proj_range, prange, proj_argmax, px, py, c = _setup(rng, p=500)
    packed = tknn.pack_range_image(torch.from_numpy(proj_range),
                                   torch.from_numpy(proj_argmax))
    args = (packed, torch.from_numpy(prange), torch.from_numpy(px),
            torch.from_numpy(py))
    kw = dict(n_classes=c, knn=5, search=5, sigma=1.0, cutoff=1.0)
    launches = knn_vote.launches
    np.testing.assert_array_equal(knn_vote(*args, **kw).numpy(),
                                  knn_vote_reference(*args, **kw).numpy())
    assert knn_vote.launches == launches   # the CPU path launches no kernel


@pytest.mark.parametrize("bad", ["search", "knn", "classes", "dtype"])
def test_knn_vote_rejects_bad_inputs(bad):
    packed = torch.zeros((1, 8, 8))
    prange = torch.zeros((1, 10))
    pxy = torch.zeros((1, 10), dtype=torch.int32)
    kw = dict(n_classes=8, knn=5, search=5, sigma=1.0, cutoff=1.0)
    if bad == "search":
        kw["search"] = 4
    elif bad == "knn":
        kw["knn"] = 26
    elif bad == "classes":
        kw["n_classes"] = 32
    else:
        pxy = pxy.long()
    with pytest.raises((ValueError, TypeError)):
        knn_vote(packed, prange, pxy, pxy, **kw)
