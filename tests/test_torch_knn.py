"""Port KNN post-processing (coarse3d_tpu_torch.ops.knn / knn_vote) vs the
JAX package, on the CPU: the plain twin of kernel K2 against JAX
``knn_postprocess`` and against the JAX Pallas vote kernel in interpret mode.
The CUDA kernel itself is held against the twin on the card by
chip_smoke.py; here ``_k2_schedule``, a plain mirror of its tiled schedule,
is held exactly equal to the twin."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import coarse3d_tpu.ops.pallas.knn_vote as jkv
from coarse3d_tpu.ops import knn as jknn
from coarse3d_tpu_torch.ops import knn as tknn
from coarse3d_tpu_torch.ops import knn_vote as k2
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


def _k2_schedule(packed, prange, px, py, *, n_classes, knn, search, sigma,
                 cutoff):
    """K2's schedule on the card (csrc/knn_vote.cu), in plain PyTorch.

    Points are bucketed by image tile (TILE_H x TILE_W) after the clip of
    the flat pixel index, cut into chunks of at most CHUNK points that never
    cross a tile; each chunk reads its tile plus the (S-1)/2 halo (zeros
    outside the image) and takes every point's S*S taps from it; the k
    smallest packed distances by a min/max insertion list (k <= 8) or k
    rounds of first-minimum extraction; the vote counted in bit-sliced
    planes and
    read from the top plane down (ties to the lowest class, 1 when no pick
    counts). The kernel's order within a tile varies; the mirror takes the
    stable one, and no label depends on it.
    """
    b, h, w = packed.shape
    p = prange.shape[1]
    pad, s2 = search // 2, search * search
    center = s2 // 2
    flat = (torch.arange(b)[:, None] * (h * w) + py.long() * w
            + px.long()).reshape(-1).clamp(0, b * h * w - 1)
    img, rem = flat // (h * w), flat % (h * w)
    y, x = rem // w, rem % w
    tiles_x = -(-w // k2.TILE_W)
    per_img = -(-h // k2.TILE_H) * tiles_x
    tile = img * per_img + (y // k2.TILE_H) * tiles_x + x // k2.TILE_W
    n_tiles, max_chunks = k2.tile_layout(b, p, h, w)
    counts = torch.bincount(tile, minlength=n_tiles)
    order = torch.argsort(tile, stable=True)
    offsets = torch.cumsum(counts, 0) - counts
    chunks = [(t, int(offsets[t]) + s, min(k2.CHUNK, int(counts[t]) - s))
              for t in range(n_tiles) for s in range(0, int(counts[t]),
                                                     k2.CHUNK)]
    assert len(chunks) <= max_chunks
    bits = packed.contiguous().view(torch.int32)
    gauss = torch.from_numpy(tknn._inv_gaussian_kernel(search, sigma).copy())
    r0_all = prange.reshape(-1)
    out = torch.full((b * p,), -1, dtype=torch.int32)
    valid_labels = ((1 << n_classes) - 1) & ~1
    for t, start, n in chunks:
        im, rt = divmod(t, per_img)
        ty, tx = divmod(rt, tiles_x)
        y0, x0 = ty * k2.TILE_H - pad, tx * k2.TILE_W - pad
        win = torch.zeros(k2.TILE_H + 2 * pad, k2.TILE_W + 2 * pad,
                          dtype=torch.int32)
        ya, yb = max(y0, 0), min(y0 + win.shape[0], h)
        xa, xb = max(x0, 0), min(x0 + win.shape[1], w)
        win[ya - y0:yb - y0, xa - x0:xb - x0] = bits[im, ya:yb, xa:xb]
        rec = order[start:start + n]
        ly, lx = y[rec] - y0 - pad, x[rec] - x0 - pad
        taps = torch.stack([win[ly + dy, lx + dx] for dy in range(search)
                            for dx in range(search)], dim=-1)   # (n, S*S)
        r0 = r0_all[rec]
        r = (taps & ~tknn.LABEL_MASK).view(torch.float32).clone()
        r[:, center] = r0
        d = torch.abs(r - r0[:, None]) * gauss + 1.0
        work = ((d.view(torch.int32) & ~tknn.LABEL_MASK)
                | (taps & tknn.LABEL_MASK)).view(torch.float32)
        if knn <= 8:                   # the insertion list of length k
            best = torch.full((n, knn), 3.0e38)
            for t in range(s2):
                v = work[:, t]
                for q in range(knn):
                    lo = torch.minimum(best[:, q], v)
                    v = torch.maximum(best[:, q], v)
                    best[:, q] = lo
            picks = best.T
        else:                          # k rounds of first-minimum extraction
            picks, rows = [], torch.arange(n)
            for _ in range(knn):
                j = torch.argmin(work, dim=1)
                picks.append(work[rows, j].clone())
                work[rows, j] = 3.0e38
        planes = [torch.zeros(n, dtype=torch.int64) for _ in range(6)]
        for m in picks:
            mbits = m.contiguous().view(torch.int32)
            label = (mbits & tknn.LABEL_MASK).long()
            if cutoff > 0:
                dist = (mbits & ~tknn.LABEL_MASK).view(torch.float32) - 1.0
                label = torch.where(dist > cutoff, n_classes, label)
            carry = torch.ones(n, dtype=torch.int64) << label
            for q in range(6):
                c = planes[q] & carry
                planes[q] = planes[q] ^ carry
                carry = c
        cand = torch.full((n,), valid_labels, dtype=torch.int64)
        for q in reversed(range(6)):
            hit = cand & planes[q]
            cand = torch.where(hit != 0, hit, cand)
        lowest = cand & -cand
        out[rec] = torch.log2(lowest.double()).round().to(torch.int32)
    assert bool((out >= 1).all())
    return out.view(b, p)


def _tiled_case(seed, h, w, sorted_order, b=2, p=3000, heavy=1500, c=8):
    """Scans at an image size the tile does not divide, points near their
    pixel's range, some pixels outside the image, and ``heavy`` padding
    points of each scan on one pixel (more than one chunk of one tile)."""
    rng = np.random.default_rng(seed)
    proj_range, prange, proj_argmax, px, py, _ = _setup(
        rng, b=b, p=p, h=h, w=w, c=c)
    prange = _near_ranges(rng, proj_range, px, py)
    out_of_image = rng.random((b, p)) < 0.02
    px = np.where(out_of_image, rng.integers(-3, w + 3, (b, p)), px)
    py = np.where(out_of_image, rng.integers(-3, h + 3, (b, p)), py)
    px[:, -heavy:] = 0
    py[:, -heavy:] = 0
    prange[:, -heavy:] = 0.0
    if sorted_order:                       # ring order: by flat pixel
        key = np.clip(py, 0, h - 1) * w + np.clip(px, 0, w - 1)
        idx = np.argsort(key, axis=1, kind="stable")
        px, py, prange = (np.take_along_axis(a, idx, 1)
                          for a in (px, py, prange))
    packed = tknn.pack_range_image(torch.from_numpy(proj_range),
                                   torch.from_numpy(proj_argmax))
    return (packed, torch.from_numpy(prange.astype(np.float32)),
            torch.from_numpy(px.astype(np.int32)),
            torch.from_numpy(py.astype(np.int32)), c)


@pytest.mark.parametrize("order", ["random", "sorted"])
@pytest.mark.parametrize("hw", [(40, 1800), (13, 300)])
@pytest.mark.parametrize("cutoff", [0.0, 1.0])
@pytest.mark.parametrize("knn", [1, 5, 9])
@pytest.mark.parametrize("search", [3, 5, 7])
def test_k2_schedule_equals_the_twin(search, knn, cutoff, hw, order):
    h, w = hw
    packed, prange, px, py, c = _tiled_case(search * 7 + knn, h, w,
                                            order == "sorted")
    kw = dict(n_classes=c, knn=knn, search=search, sigma=1.0, cutoff=cutoff)
    want = knn_vote_reference(packed, prange, px, py, **kw)
    got = _k2_schedule(packed, prange, px, py, **kw)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
