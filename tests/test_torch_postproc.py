"""The port's post-processing (coarse3d_tpu_torch.postproc, the CRF eval
step, tools/train_crf.py, evaluate --crf) vs the JAX package's, on the CPU
in float32, the same numpy inputs on both sides.

Tolerances: ``init_compat_kernel`` and ``border_mask`` exact; ``crf_refine``
within 1e-6; its gradient in the compatibility kernel within 1e-5 of
``jax.grad``; the CRF eval step's 2D argmax agrees on >= 0.999 of pixels
(ties of two refined probabilities may fall either way) and the confusion
matrix is equal where the argmax is; ``train_crf``'s history and fitted
kernel within 1e-4 of the JAX tool's on the same checkpoint, carried
across by ``train_state_from_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coarse3d_tpu.configs import preset as jax_preset
from coarse3d_tpu.data.synthetic import synthetic_batch as jax_batch
from coarse3d_tpu.ops import projection as jproj
from coarse3d_tpu.postproc import border as jborder
from coarse3d_tpu.postproc import crf as jcrf
from coarse3d_tpu.tools import train_crf as jax_train_crf
from coarse3d_tpu.train import checkpoint as jckpt
from coarse3d_tpu.train import setup as jsetup
from coarse3d_tpu.train import step as jstep
from coarse3d_tpu_torch import postproc
from coarse3d_tpu_torch.configs import preset
from coarse3d_tpu_torch.ops import projection as tproj
from coarse3d_tpu_torch.postproc import border as tborder
from coarse3d_tpu_torch.postproc import crf as tcrf
from coarse3d_tpu_torch.tools import evaluate as evaluate_cli
from coarse3d_tpu_torch.tools import train_crf as train_crf_cli
from coarse3d_tpu_torch.tools.convert_jax_params import train_state_from_jax
from coarse3d_tpu_torch.train import checkpoint as tckpt
from coarse3d_tpu_torch.train import setup as tsetup
from coarse3d_tpu_torch.train import step as tstep
from tests.test_torch_salsanext import _randomize

B, H, W, C = 2, 12, 20, 6


def _crf_inputs(seed=0):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(0, 0.6, (B, H, W, 3)).astype(np.float32)
    logits = rng.normal(0, 2.0, (B, H, W, C)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    mask = rng.random((B, H, W)) > 0.3          # ragged: 30 % of pixels out
    kernel = (0.1 * (1 - np.eye(C)) + rng.normal(0, 0.05, (C, C))).astype(
        np.float32)
    return xyz, probs.astype(np.float32), mask, kernel


def test_package_surface_matches_jax():
    from coarse3d_tpu import postproc as jpost

    assert postproc.__all__ == jpost.__all__
    assert postproc.crf_refine is tcrf.crf_refine
    assert postproc.border_mask is tborder.border_mask


@pytest.mark.parametrize("n,coef", [(6, 0.1), (20, 0.25)])
def test_init_compat_kernel_exact(n, coef):
    np.testing.assert_array_equal(
        tcrf.init_compat_kernel(n, coef).numpy(),
        np.asarray(jcrf.init_compat_kernel(n, coef)))


@pytest.mark.parametrize("lcn", [(3, 5), (5, 5)])
@pytest.mark.parametrize("iterations", [1, 3])
def test_crf_refine_matches_jax(lcn, iterations):
    xyz, probs, mask, kernel = _crf_inputs()
    kw = dict(iterations=iterations, lcn_h=lcn[0], lcn_w=lcn[1])
    want = np.asarray(jcrf.crf_refine(
        jnp.asarray(xyz), jnp.asarray(probs), jnp.asarray(mask),
        jnp.asarray(kernel), **kw))
    got = tcrf.crf_refine(torch.from_numpy(xyz), torch.from_numpy(probs),
                          torch.from_numpy(mask), torch.from_numpy(kernel),
                          **kw).numpy()
    print(f"max abs err {np.abs(got - want).max():.3e}; the refinement moved "
          f"the map by {np.abs(want - probs).max():.3e}")
    assert np.abs(want - probs).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_crf_mask_silences_neighbours_only():
    """A masked pixel sends no message but still receives one and keeps its
    own residual: the refined map differs from the input there."""
    xyz, probs, mask, kernel = _crf_inputs(1)
    args = [torch.from_numpy(a) for a in (xyz, probs)]
    k = torch.from_numpy(kernel)
    got = tcrf.crf_refine(*args, torch.from_numpy(mask), k, iterations=1)
    everyone = tcrf.crf_refine(*args, torch.ones(B, H, W, dtype=torch.bool),
                               k, iterations=1)
    assert not torch.allclose(got, everyone)
    out = torch.from_numpy(~mask)
    assert float((got - args[1]).abs()[out].max()) > 1e-3


def test_crf_kernel_gradient_matches_jax():
    xyz, probs, mask, kernel = _crf_inputs(2)
    target = np.random.default_rng(5).integers(0, C, (B, H, W))

    def jloss(k):
        refined = jcrf.crf_refine(jnp.asarray(xyz), jnp.asarray(probs),
                                  jnp.asarray(mask), k)
        picked = jnp.take_along_axis(jnp.log(refined + 1e-10),
                                     jnp.asarray(target)[..., None], -1)
        return -picked.mean()

    want_loss, want = jax.value_and_grad(jloss)(jnp.asarray(kernel))
    k = torch.from_numpy(kernel).requires_grad_()
    refined = tcrf.crf_refine(torch.from_numpy(xyz), torch.from_numpy(probs),
                              torch.from_numpy(mask), k)
    loss = -torch.gather(torch.log(refined + 1e-10), -1,
                         torch.from_numpy(target)[..., None]).mean()
    loss.backward()
    print(f"grad max abs {np.abs(np.asarray(want)).max():.3e}, err "
          f"{np.abs(k.grad.numpy() - np.asarray(want)).max():.3e}")
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-6)
    assert np.abs(np.asarray(want)).max() > 1e-3
    np.testing.assert_allclose(k.grad.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("kind", ["cross", "square"])
@pytest.mark.parametrize("size", [1, 3])
def test_border_mask_exact(kind, size):
    rng = np.random.default_rng(3)
    # blocky labels: borders and interiors both present
    coarse = rng.integers(0, C, (B, 4, 5))
    labels = np.kron(coarse, np.ones((1, 6, 8), np.int64)).astype(np.int32)
    labels[0, :3, :3] = C + 2                   # out of range: no class
    want = np.asarray(jborder.border_mask(jnp.asarray(labels), C,
                                          border_size=size, kind=kind))
    got = tborder.border_mask(torch.from_numpy(labels), C, border_size=size,
                              kind=kind)
    assert got.dtype == torch.bool and 0 < want.mean() < 1
    np.testing.assert_array_equal(got.numpy(), want)


# -- the unbatched projection and the label scatter ---------------------------

def test_range_project_and_scatter_labels_match_jax():
    from coarse3d_tpu_torch.data.synthetic import pad_points, synthetic_scan

    sensor = preset("tiny").sensor
    scan = synthetic_scan(np.random.default_rng(4), 3000, 8, sensor)
    pts, valid = pad_points(scan["points"], 4096)
    labels = np.zeros(4096, np.int32)
    labels[:3000] = scan["labels"]
    for excl0 in (False, True):
        want = jproj.range_project(jnp.asarray(pts), jnp.asarray(valid),
                                   sensor, mask_excludes_point0=excl0)
        got = tproj.range_project(torch.from_numpy(pts),
                                  torch.from_numpy(valid), sensor,
                                  mask_excludes_point0=excl0)
        assert set(got) == set(want)
        batched = tproj.range_project_batch(
            torch.from_numpy(pts)[None], torch.from_numpy(valid)[None],
            sensor, excl0)
        for k in want:
            w = np.asarray(want[k])
            assert tuple(got[k].shape) == w.shape, k
            assert torch.equal(got[k], batched[k][0]), k
            # an ulp of atan2 / asin at a pixel edge may move a point, and
            # the two norms differ by an ulp
            agree = float(np.isclose(got[k].numpy(), w, rtol=1e-6,
                                     atol=0).mean())
            assert agree >= 0.999, (k, agree)
    idx = np.asarray(want["proj_idx"])
    np.testing.assert_array_equal(
        tproj.scatter_labels(torch.from_numpy(idx),
                             torch.from_numpy(labels)).numpy(),
        np.asarray(jproj.scatter_labels(jnp.asarray(idx),
                                        jnp.asarray(labels))))
    np.testing.assert_array_equal(
        tproj.scatter_labels(torch.from_numpy(idx),
                             torch.from_numpy(labels)).numpy(),
        tproj.scatter_labels_np(idx, labels))


# -- the eval step with the CRF ----------------------------------------------

def _randomized_jax_state(cfg_j, batch_size, seed=0):
    """A JAX train state whose BatchNorm statistics and affines are
    randomised, so its label map is not constant."""
    state = jsetup.build_state(cfg_j, jax.random.key(seed), steps_per_epoch=1,
                               batch_size=batch_size)
    rng = np.random.default_rng(seed)

    def stats(k, v, rng):
        if k == "mean":
            return rng.normal(0, 0.5, v.shape).astype(np.float32)
        return rng.uniform(0.5, 2.0, v.shape).astype(np.float32)

    def params(k, v, rng):
        if k == "scale":
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        return v

    return state.replace(
        params=_randomize(jax.device_get(state.params), rng, params),
        batch_stats=_randomize(jax.device_get(state.batch_stats), rng, stats))


@pytest.fixture(scope="module")
def states():
    cfg_t, cfg_j = preset("tiny"), jax_preset("tiny")
    host = jax_batch(np.random.default_rng(0), cfg_j, 2, n_points=3000,
                     weak_ratio=0.01)
    jstate = _randomized_jax_state(cfg_j, 2)
    tstate = tsetup.build_state(cfg_t, device="cpu", steps_per_epoch=1)
    tstate.load(train_state_from_jax(jax.device_get(jstate)))
    return {"cfg_t": cfg_t, "cfg_j": cfg_j, "jstate": jstate,
            "tstate": tstate, "host": host,
            "jb": {k: jnp.asarray(v) for k, v in host.items()},
            "tb": tstep.batch_to_device(host, torch.device("cpu"))}


@pytest.mark.parametrize("use_knn,given_kernel", [
    (False, False), (True, False), (False, True)])
def test_eval_step_crf_matches_jax(states, use_knn, given_kernel):
    n = states["cfg_t"].data.n_classes
    kernel = None
    if given_kernel:
        kernel = (0.3 * (1 - np.eye(n)) + np.random.default_rng(1).normal(
            0, 0.1, (n, n))).astype(np.float32)
    kw = dict(use_knn=use_knn, use_crf=True, crf_kernel=kernel)
    want = jax.jit(jstep.make_eval_step(states["cfg_j"], **kw))(
        states["jstate"], states["jb"])
    got = tstep.make_eval_step(states["cfg_t"], **kw)(
        states["tstate"], states["tb"])
    plain = tstep.make_eval_step(states["cfg_t"], use_knn=use_knn)(
        states["tstate"], states["tb"])
    w2d = np.asarray(want["argmax_2d"])
    agree = float((got["argmax_2d"].numpy() == w2d).mean())
    moved = float((got["argmax_2d"] != plain["argmax_2d"]).float().mean())
    print(f"argmax_2d agreement {agree:.6f}; the CRF moved {moved:.4f} of "
          f"pixels; {len(np.unique(w2d))} classes")
    assert got["argmax_2d"].dtype == torch.int32
    assert agree >= 0.999 and moved > 0 and len(np.unique(w2d)) > 1
    conf_w = np.asarray(want["confusion"])
    assert int(got["confusion"].sum()) == int(conf_w.sum())
    if agree == 1.0:
        np.testing.assert_array_equal(got["confusion"].numpy(), conf_w)


# -- tools/train_crf.py and evaluate --crf ------------------------------------

_DATA = ["--preset", "tiny", "--synthetic", "2", "--synthetic_points", "500",
         "--num_workers", "1"]


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    """One tiny checkpoint in both packages' run-dir layouts: the JAX state
    saved through Orbax, and carried across into a port checkpoint."""
    root = tmp_path_factory.mktemp("crf")
    cfg_j, cfg_t = jax_preset("tiny"), preset("tiny")
    jstate = _randomized_jax_state(cfg_j, 2, seed=3)
    mgr = jckpt.CheckpointManager(str(root / "jax"))
    mgr.save_rolling(jstate, 0)
    mgr.close()
    tstate = tsetup.build_state(cfg_t, device="cpu", steps_per_epoch=1)
    tstate.load(train_state_from_jax(jax.device_get(jstate)))
    tckpt.CheckpointManager(str(root / "port")).save_rolling(tstate, 0)
    return root


@pytest.mark.parametrize("balance", [False, True])
def test_train_crf_matches_jax_tool(run_dirs, balance, tmp_path):
    args = _DATA + ["--ckpt", "latest", "--synthetic_task", "bands",
                    "--weak", "0.01", "--batch_size", "2", "--epochs", "2",
                    "--lr", "0.05"] + (["--class_balance"] if balance else [])
    want = jax_train_crf.main(args + ["--run_dir", str(run_dirs / "jax"),
                                      "--out", str(tmp_path / "j.npz")])
    out = tmp_path / "sub" / "t.npz"
    got = train_crf_cli.main(args + ["--run_dir", str(run_dirs / "port"),
                                     "--out", str(out), "--device", "cpu"])
    print(f"history port {got['history']} jax {want['history']}; kernel max "
          f"abs err {np.abs(got['kernel'] - want['kernel']).max():.3e}")
    np.testing.assert_allclose(got["history"], want["history"], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got["kernel"], want["kernel"], rtol=0,
                               atol=1e-4)
    n = got["kernel"].shape[0]
    init = tcrf.init_compat_kernel(n, 0.1).numpy()
    assert np.abs(got["kernel"] - init).max() > 1e-4
    saved = np.load(out)
    np.testing.assert_array_equal(saved["kernel"], got["kernel"])
    np.testing.assert_array_equal(saved["history"],
                                  np.asarray(got["history"], np.float32))

    # evaluate --crf --crf_kernel consumes it
    common = _DATA + ["--device", "cpu", "--batch_size", "2", "--run_dir",
                      str(run_dirs / "port")]
    fitted = evaluate_cli.main(common + ["--crf", "--crf_kernel", str(out)])
    untrained = evaluate_cli.main(common + ["--crf"])
    raw = evaluate_cli.main(common)
    assert fitted["crf"] and untrained["crf"] and not raw["crf"]
    assert 0.0 <= fitted["mIoU_3D"] <= 1.0
    assert int(np.sum(fitted["confusion"])) == int(np.sum(raw["confusion"]))


def test_crf_kernel_alone_exits_as_jax_tool(tmp_path):
    from coarse3d_tpu.tools import evaluate as jax_evaluate

    argv = _DATA + ["--crf_kernel", str(tmp_path / "k.npz")]
    with pytest.raises(SystemExit) as want:
        jax_evaluate.main(argv)
    with pytest.raises(SystemExit) as got:
        evaluate_cli.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value) == "--crf_kernel requires --crf"


def test_train_crf_defaults_to_cuda(run_dirs, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_crf_cli.main(_DATA + ["--run_dir", str(run_dirs / "port"),
                                    "--out", str(tmp_path / "k.npz")])
