"""Port losses and class gathers vs the JAX package's, on the CPU at the
tiny size (B=2, 16x64, 8 classes, D=32, A=32), inputs from a numpy seed and
noise drawn by jax.random and handed to both sides. Tolerances:

- focal / Lovász: loss within 1e-6 relative (budget None, a small budget,
  an empty mask); d loss / d probs within 1e-5 (float32 sums in another
  order); ``lovasz_budget_overflow`` exact;
- gather: ``gather_class_indices`` and ``rank_within_class`` exactly equal
  (stable sorts on both sides), with an over-budget class, an empty class
  and invalid elements;
- entropy selection: pseudo labels and mask exactly equal on the same
  Gumbel noise, at select ratios 0, 0.3 and 1, with weak labels >= C;
- contrast: anchor draws equal on >= 0.999 of (image, class, anchor) slots
  (a float32 cumsum may differ at a CDF boundary), loss and d loss /
  d embedding within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coarse3d_tpu.configs.config import ContrastConfig as JaxContrastConfig
from coarse3d_tpu.losses import contrast as jcontrast
from coarse3d_tpu.losses import entropy_selection as jsel
from coarse3d_tpu.losses import focal as jfocal
from coarse3d_tpu.losses import lovasz as jlovasz
from coarse3d_tpu.ops import gather as jgather
from coarse3d_tpu_torch.configs.config import ContrastConfig
from coarse3d_tpu_torch.losses import contrast as tcontrast
from coarse3d_tpu_torch.losses import entropy_selection as tsel
from coarse3d_tpu_torch.losses import focal as tfocal
from coarse3d_tpu_torch.losses import lovasz as tlovasz
from coarse3d_tpu_torch.ops import gather as tgather

B, H, W, C, D, A = 2, 16, 64, 8, 32, 32


def _probs(rng):
    logits = rng.normal(0, 2, (B, H, W, C)).astype(np.float32)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    probs = _probs(rng)
    labels = rng.integers(0, C, (B, H, W)).astype(np.int32)
    weak = np.where(rng.random((B, H, W)) < 0.05, labels, 0).astype(np.int32)
    eval_mask = rng.random((B, H, W)) < 0.8
    emb = rng.normal(size=(B, H, W, D)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    protos = rng.normal(size=(C, 4, D)).astype(np.float32)
    return dict(probs=probs, labels=labels, weak=weak, eval_mask=eval_mask,
                emb=emb, protos=protos)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


# -- focal --------------------------------------------------------------------

def test_focal_alpha_copy_matches_jax():
    counts = (0.0, 10.0, 300.0, 5.0, 77.0)
    np.testing.assert_array_equal(tfocal.focal_alpha_from_counts(counts),
                                  jfocal.focal_alpha_from_counts(counts))
    mask = (True, False, False, True, False)
    np.testing.assert_array_equal(
        tfocal.focal_alpha_from_counts(counts, mask, ignore_cls=0),
        jfocal.focal_alpha_from_counts(counts, mask, ignore_cls=0))


@pytest.mark.parametrize("mask_kind", ["weak", "none", "empty"])
def test_focal_loss_and_grad(data, mask_kind):
    alpha = jfocal.focal_alpha_from_counts([0.0] + [float(i) for i in
                                                    range(1, C)])
    mask = {"weak": data["weak"] > 0, "none": None,
            "empty": np.zeros((B, H, W), bool)}[mask_kind]

    def jloss(p):
        return jfocal.focal_softmax_loss(
            p, jnp.asarray(data["labels"]), jnp.asarray(alpha),
            None if mask is None else jnp.asarray(mask))

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(data["probs"]))
    p = _t(data["probs"], grad=True)
    got = tfocal.focal_softmax_loss(
        p, _t(data["labels"]), torch.from_numpy(alpha),
        None if mask is None else _t(mask))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g), rtol=0,
                               atol=1e-5)
    if mask_kind == "empty":
        assert float(got.detach()) == 0.0


# -- Lovász -------------------------------------------------------------------

@pytest.mark.parametrize("budget,labels_kind", [
    (None, "weak"), (64, "weak"), (None, "all_ignored"), (None, "dense"),
    (5000, "dense")])
def test_lovasz_loss_and_grad(data, budget, labels_kind):
    labels = {"weak": data["weak"], "dense": data["labels"],
              "all_ignored": np.zeros((B, H, W), np.int32)}[labels_kind]

    def jloss(p):
        return jlovasz.lovasz_softmax_loss(p, jnp.asarray(labels), ignore=0,
                                           budget=budget)

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(data["probs"]))
    p = _t(data["probs"], grad=True)
    got = tlovasz.lovasz_softmax_loss(p, _t(labels), ignore=0, budget=budget)
    got.backward()
    print(f"lovasz {labels_kind} budget={budget}: {float(got.detach())} vs "
          f"{float(want)}")
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g), rtol=0,
                               atol=1e-5)
    for b in (0, 64, 100, 10 ** 6):
        assert int(tlovasz.lovasz_budget_overflow(_t(labels), 0, b)) == int(
            jlovasz.lovasz_budget_overflow(jnp.asarray(labels), 0, b))


def test_lovasz_classes_all(data):
    want = jlovasz.lovasz_softmax_loss(
        jnp.asarray(data["probs"]), jnp.asarray(data["weak"]), classes="all")
    got = tlovasz.lovasz_softmax_loss(_t(data["probs"]), _t(data["weak"]),
                                      classes="all")
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=0)


# -- gather -------------------------------------------------------------------

def _gather_inputs(seed=1, n=700):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, C, n).astype(np.int32)
    labels[labels == 5] = 4          # class 5 empty
    labels[:300] = 2                 # class 2 over the budget
    valid = rng.random(n) < 0.8
    scores = rng.normal(size=n).astype(np.float32)
    scores[10:20] = scores[0]        # ties keep the element order
    return labels, valid, scores


@pytest.mark.parametrize("budget", [16, 128])
def test_gather_class_indices_exact(budget):
    labels, valid, _ = _gather_inputs()
    widx, wmask = jgather.gather_class_indices(
        jnp.asarray(labels), jnp.asarray(valid), C, budget)
    gidx, gmask = tgather.gather_class_indices(
        _t(labels), _t(valid), C, budget)
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(widx))
    assert not gmask[5].any() and gmask[2].all()


def test_class_ranges_and_rank_within_class_exact():
    labels, valid, scores = _gather_inputs(2)
    keys = np.where(valid, labels, C).astype(np.int32)
    for w, g in zip(jgather.class_ranges(jnp.asarray(keys), C),
                    tgather.class_ranges(_t(keys), C)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    wr, wc = jgather.rank_within_class(
        jnp.asarray(scores), jnp.asarray(labels), jnp.asarray(valid), C)
    gr, gc = tgather.rank_within_class(_t(scores), _t(labels), _t(valid), C)
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


# -- entropy selection ----------------------------------------------------------

@pytest.mark.parametrize("ratio", [0.0, 0.3, 1.0])
def test_entropy_selection_exact(data, ratio):
    weak = data["weak"].copy()
    weak[0, 0, :3] = [C, C + 2, 3 * C]     # labels >= C among the weak labels
    wss = weak > 0
    key = jax.random.key(5)
    want_l, want_m = jsel.entropy_based_selection(
        jnp.asarray(data["probs"]), jnp.asarray(wss),
        jnp.asarray(data["eval_mask"]), jnp.asarray(weak), ratio, key)
    gumbel = np.asarray(jax.random.gumbel(key, (B * H * W,), jnp.float32))
    got_l, got_m = tsel.entropy_based_selection(
        _t(data["probs"]), _t(wss), _t(data["eval_mask"]), _t(weak), ratio,
        _t(gumbel))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    print(f"ratio {ratio}: {int(got_m.sum())} pseudo-labelled pixels")


# -- contrast -----------------------------------------------------------------

def _contrast_args(data):
    sel_l, sel_m = jsel.entropy_based_selection(
        jnp.asarray(data["probs"]), jnp.asarray(data["weak"] > 0),
        jnp.asarray(data["eval_mask"]), jnp.asarray(data["weak"]), 0.3,
        jax.random.key(9))
    return np.asarray(sel_l), np.asarray(sel_m)


def test_sample_anchors_agree(data):
    labels, _ = _contrast_args(data)
    key = jax.random.key(3)
    want, _, want_valid = jcontrast.sample_anchors(
        jnp.asarray(data["emb"]), jnp.asarray(data["probs"]),
        jnp.asarray(labels), key, A)
    u = np.asarray(jax.random.uniform(key, (B, C, A), minval=0.0, maxval=1.0))
    got, cls_ids, got_valid = tcontrast.sample_anchors(
        _t(data["emb"]), _t(data["probs"]), _t(labels), _t(u))
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(cls_ids.numpy(), np.arange(C))
    same = (got.numpy() == np.asarray(want)).all(-1)
    print(f"anchor draws equal on {same.mean():.6f} of slots")
    assert same.mean() >= 0.999


def test_contrast_loss_and_grad(data):
    labels, keep = _contrast_args(data)
    key = jax.random.key(4)
    jcfg = JaxContrastConfig(num_anchor=A, sub_proto_size=4, proj_dim=D)
    tcfg = ContrastConfig(num_anchor=A, sub_proto_size=4, proj_dim=D)

    def jloss(emb):
        return jcontrast.contrast_mem_loss(
            emb, jnp.asarray(data["probs"]), jnp.asarray(labels),
            jnp.asarray(keep), jnp.asarray(data["protos"]), key, jcfg)

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(data["emb"]))
    u = np.asarray(jax.random.uniform(key, (B, C, A), minval=0.0, maxval=1.0))
    emb = _t(data["emb"], grad=True)
    got = tcontrast.contrast_mem_loss(
        emb, _t(data["probs"]), _t(labels), _t(keep), _t(data["protos"]),
        _t(u), tcfg)
    got.backward()
    print(f"contrast {float(got.detach())} vs {float(want)}")
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(emb.grad.numpy(), np.asarray(want_g), rtol=0,
                               atol=1e-5)


def test_contrast_loss_empty_keep_mask(data):
    tcfg = ContrastConfig(num_anchor=A, sub_proto_size=4, proj_dim=D)
    u = np.random.default_rng(0).random((B, C, A)).astype(np.float32)
    got = tcontrast.contrast_mem_loss(
        _t(data["emb"]), _t(data["probs"]), _t(data["labels"]),
        _t(np.zeros((B, H, W), bool)), _t(data["protos"]), _t(u), tcfg)
    assert float(got) == 0.0
