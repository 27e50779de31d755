"""Port metrics (coarse3d_tpu_torch.metrics.iou) vs the JAX package's, on
the CPU: the confusion matrix exactly equal, with and without a valid mask;
IoU, precision ('Acc') and recall within 1e-6 (float32 both sides)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coarse3d_tpu.metrics import iou as jiou
from coarse3d_tpu_torch.metrics import iou as tiou

C = 8


def _inputs(seed, n=5000):
    rng = np.random.default_rng(seed)
    pred = rng.integers(0, C, n).astype(np.int32)
    target = rng.integers(0, C, n).astype(np.int32)
    target[:40] = C + 3          # out-of-range labels land as JAX puts them
    valid = rng.random(n) < 0.7
    return pred, target, valid


@pytest.mark.parametrize("with_valid", [False, True])
def test_confusion_matrix_exact(with_valid):
    pred, target, valid = _inputs(0)
    v = valid if with_valid else None
    want = np.asarray(jiou.confusion_matrix(
        jnp.asarray(pred), jnp.asarray(target), C,
        None if v is None else jnp.asarray(v)))
    got = tiou.confusion_matrix(
        torch.from_numpy(pred), torch.from_numpy(target), C,
        None if v is None else torch.from_numpy(v))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["iou", "acc", "recall"])
@pytest.mark.parametrize("ignore", [(0,), (0, 3)])
def test_stats_from_confusion(name, ignore):
    pred, target, valid = _inputs(1)
    conf = np.array(jiou.confusion_matrix(
        jnp.asarray(pred), jnp.asarray(target), C, jnp.asarray(valid)))
    conf[2] = 0                                      # an empty class row
    jf = getattr(jiou, f"{name}_from_confusion")
    tf = getattr(tiou, f"{name}_from_confusion")
    wm, wv = jf(jnp.asarray(conf), ignore)
    gm, gv = tf(torch.from_numpy(conf), ignore)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(gm), float(wm), rtol=0, atol=1e-6)


def test_confusion_state_accumulates():
    js = jiou.ConfusionState(C)
    ts = tiou.ConfusionState(C)
    for seed in (2, 3):
        pred, target, valid = _inputs(seed)
        target = np.minimum(target, C - 1)
        js.add_batch(pred, target, valid)
        ts.add_batch(pred, target, valid)
    np.testing.assert_array_equal(ts.conf, js.conf)
    for name in ("iou", "acc", "recall"):
        wm, _ = getattr(js, name)()
        gm, _ = getattr(ts, name)()
        np.testing.assert_allclose(float(gm), float(wm), rtol=0, atol=1e-6)
    ts.reset()
    assert ts.conf.sum() == 0
