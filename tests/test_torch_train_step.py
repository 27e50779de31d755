"""The port's training step (coarse3d_tpu_torch.train.step) vs the JAX
package's ``make_train_step``, on the CPU at the tiny preset (B=2, 16x64,
8 classes, K=4, D=32, M=128, A=32), in float32.

Both sides run one warmup step and two contrast steps at select ratio 0.3
on the same numpy batch and the same noise (JAX's own split of its state
key, handed to the port). Before each step the port loads JAX's state,
carried across by ``tools/convert_jax_params.py:train_state_from_jax``, so
each comparison is one step of float noise, not three compounded.
Dropout is 0 on both sides, through the config: Flax's dropout stream
cannot be reproduced. The state is built with steps_per_epoch=1, so the
warmup schedule is one step long and the second and third updates run at
the full learning rate (the first runs at lr 0, as optax's count starts at
0).

Tolerances, after every step:
- each loss term within 1e-4 relative (float32 through a 30-layer network);
- BatchNorm running mean / var within 1e-5 relative (mean: also atol 1e-5);
- gradients, through Adam's first moment, and parameters: see
  ``test_gradients_and_params_match`` (elementwise where no leaky-ReLU kink
  lies on the way, by direction and norm elsewhere), and
  ``test_optimizer_matches_optax`` for the update rule on equal gradients;
- prototypes and memory diagnostics within 1e-5;
- the confusion matrix exactly equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coarse3d_tpu.configs import preset as jax_preset
from coarse3d_tpu.data.synthetic import synthetic_batch as jax_batch
from coarse3d_tpu.train import setup as jsetup
from coarse3d_tpu.train import step as jstep
from coarse3d_tpu_torch.configs import preset
from coarse3d_tpu_torch.data.synthetic import synthetic_batch
from coarse3d_tpu_torch.tools.convert_jax_params import (
    params_from_jax,
    train_state_from_jax,
)
from coarse3d_tpu_torch.train import setup as tsetup
from coarse3d_tpu_torch.train import step as tstep
from coarse3d_tpu_torch.train.schedule import warmup_cosine_schedule

RATIO = 0.3
PLAN = (False, True, True)          # warmup step, then two contrast steps


def _no_dropout(cfg):
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dropout_rate=0.0))


def _jax_noise(rng, cfg, b, h, w):
    """The noise JAX's train step draws from its state key (step.py:78-79,
    and update_prototypes' per-class split)."""
    _, _, select_rng, anchor_rng, proto_rng = jax.random.split(rng, 5)
    c = cfg.data.n_classes
    m, k = cfg.contrast.max_pixels_per_class, cfg.contrast.sub_proto_size
    return {
        "select": np.array(jax.random.gumbel(select_rng, (b * h * w,),
                                               jnp.float32)),
        "anchor": np.array(jax.random.uniform(
            anchor_rng, (b, c, cfg.contrast.num_anchor), minval=0.0,
            maxval=1.0)),
        "proto": np.stack([
            np.asarray(jax.random.gumbel(r, (m, k), jnp.float32))
            for r in jax.random.split(proto_rng, c)]),
    }


def _snapshot_jax(state):
    adam = state.opt_state[0]
    return {"params": params_from_jax(jax.device_get(state.params)),
            "mu": params_from_jax(jax.device_get(adam.mu)),
            "stats": jax.device_get(state.batch_stats),
            "protos": np.asarray(state.prototypes)}


def _snapshot_port(state):
    return {"params": {k: v.detach().clone()
                       for k, v in state.model.named_parameters()},
            "mu": {k: state.optimizer.state[p]["exp_avg"].clone()
                   for k, p in state.model.named_parameters()},
            "buffers": {k: v.clone() for k, v in state.model.state_dict().items()
                        if "running" in k},
            "protos": state.prototypes.clone()}


@pytest.fixture(scope="module")
def run():
    cfg_t = _no_dropout(preset("tiny"))
    cfg_j = _no_dropout(jax_preset("tiny"))
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
    host = jax_batch(np.random.default_rng(0), cfg_j, 2, n_points=3000,
                     weak_ratio=0.01)
    port_host = synthetic_batch(np.random.default_rng(0), cfg_t, 2,
                                n_points=3000, weak_ratio=0.01)
    for k in host:
        np.testing.assert_array_equal(port_host[k], host[k], err_msg=k)
    jb = {k: jnp.asarray(v) for k, v in host.items()}
    tb = tstep.batch_to_device(port_host, torch.device("cpu"))
    b, h, w = host["train_label"].shape

    jstate = jsetup.build_state(cfg_j, jax.random.key(0), steps_per_epoch=1,
                                batch_size=b)
    tstate = tsetup.build_state(cfg_t, device="cpu", steps_per_epoch=1)
    alpha = jsetup.build_alpha(cfg_j)
    np.testing.assert_array_equal(tsetup.build_alpha(cfg_t), alpha)

    jsteps = {wc: jax.jit(jstep.make_train_step(cfg_j, alpha,
                                                with_contrast=wc))
              for wc in (False, True)}
    tsteps = {wc: tstep.make_train_step(cfg_t, alpha, with_contrast=wc)
              for wc in (False, True)}
    record = []
    for wc in PLAN:
        # every step starts from JAX's state, carried across: one step of
        # float noise per comparison, not three compounded
        tstate.load(train_state_from_jax(jax.device_get(jstate)))
        noise = _jax_noise(jstate.rng, cfg_j, b, h, w)
        jstate, jm = jsteps[wc](jstate, jb, RATIO)
        tstate, tm = tsteps[wc](tstate, tb, RATIO, noise if wc else None)
        record.append({"jax": _snapshot_jax(jstate), "port":
                       _snapshot_port(tstate), "jm": jax.device_get(jm),
                       "tm": tm, "contrast": wc})
    return {"cfg_t": cfg_t, "cfg_j": cfg_j, "record": record, "jb": jb,
            "tb": tb, "jstate": jstate, "tstate": tstate}


@pytest.mark.parametrize("i", range(len(PLAN)))
def test_losses_match(run, i):
    rec = run["record"][i]
    want, got = rec["jm"]["losses"], rec["tm"]["losses"]
    assert set(got) == set(want)
    for k in want:
        print(f"step {i} {k}: port {float(got[k])} jax {float(want[k])}")
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   atol=0, err_msg=k)


@pytest.mark.parametrize("i", range(len(PLAN)))
def test_confusion_and_diagnostics_match(run, i):
    rec = run["record"][i]
    np.testing.assert_array_equal(rec["tm"]["confusion"].numpy(),
                                  np.asarray(rec["jm"]["confusion"]))
    assert ("diag" in rec["tm"]) == rec["contrast"]
    if rec["contrast"]:
        for k, v in rec["jm"]["diag"].items():
            np.testing.assert_allclose(float(rec["tm"]["diag"][k]), float(v),
                                       rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("i", range(len(PLAN)))
def test_batch_stats_match(run, i):
    from coarse3d_tpu_torch.tools.convert_jax_params import state_dict_from_jax

    rec = run["record"][i]
    want = state_dict_from_jax({"params": jax.device_get(
        run["jstate"].params), "batch_stats": rec["jax"]["stats"]})
    for k, g in rec["port"]["buffers"].items():
        np.testing.assert_allclose(
            g.numpy(), want[k].numpy(), rtol=1e-5,
            atol=1e-5 if k.endswith("running_mean") else 0, err_msg=k)


# parameters whose gradient reaches them without crossing a leaky ReLU:
# the class head (fed by the last BatchNorm) and that BatchNorm's affine, and
# the projector's output conv
KINK_FREE = ("cls_head.weight", "cls_head.bias", "upBlock4.bn4.weight",
             "upBlock4.bn4.bias", "projector.proj.3.weight",
             "projector.proj.3.bias")


@pytest.mark.parametrize("i", range(len(PLAN)))
def test_gradients_and_params_match(run, i):
    """Adam's first moment holds the gradients (mu = 0.1 * grad in a step
    from zero moments, and each step here starts from JAX's moments).

    Where the gradient crosses no leaky ReLU, it is held elementwise
    (atol 1e-7 + rtol 1e-3) and so is the updated parameter (atol 1e-6
    where |mu| >= 1e-6, so that Adam's eps of 1e-8 is under 1.5 % of
    sqrt(v) and a noise-level gradient cannot steer the step).

    Everywhere else a pre-activation within an ulp of 0 can fall on the
    other side of a leaky ReLU's kink in the two float32 programs, which
    moves that pixel's gradient by 99 % and, through BatchNorm, its whole
    channel below it (found in a float64 rerun of the port: the first
    divergence sits at such a kink). There, each gradient tensor above
    noise level (max |mu| > 1e-6) must point the same way (cosine >= 0.9)
    with the same norm (ratio within 10 %).
    """
    rec = run["record"][i]
    jmu, tmu = rec["jax"]["mu"], rec["port"]["mu"]
    assert set(tmu) == set(jmu)
    worst, noise = (1.0, ""), 0
    for k in jmu:
        g, w = tmu[k].numpy().ravel(), jmu[k].numpy().ravel()
        if k in KINK_FREE:
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-7,
                                       err_msg=f"mu {k}")
            big = np.abs(w) >= 1e-6
            gp = rec["port"]["params"][k].numpy().ravel()
            wp = rec["jax"]["params"][k].numpy().ravel()
            np.testing.assert_allclose(gp[big], wp[big], rtol=0, atol=1e-6,
                                       err_msg=f"param {k}")
        if not np.abs(w).max() > 1e-6:
            noise += 1
            continue
        cos = float(g @ w / (np.linalg.norm(g) * np.linalg.norm(w)))
        ratio = float(np.linalg.norm(g) / np.linalg.norm(w))
        worst = min(worst, (cos, k))
        assert cos >= 0.9 and abs(ratio - 1) <= 0.1, (k, cos, ratio)
    print(f"step {i}: worst gradient cosine {worst[0]:.6f} ({worst[1]}); "
          f"{noise} noise-level gradient tensors not compared")


def test_optimizer_matches_optax():
    """AdamW + the warmup-cosine LambdaLR against optax.adamw on identical
    gradients (magnitudes 1e-9 .. 1), three steps: moments within 1e-6 of
    their tensor's largest value and parameters within 1e-6 (rounding only:
    torch lerps the moments and divides by sqrt(v) / sqrt(bc2), optax
    mixes them and divides by sqrt(v / bc2))."""
    cfg_t, cfg_j = preset("tiny"), jax_preset("tiny")
    jstate = jsetup.build_state(cfg_j, jax.random.key(1), steps_per_epoch=1,
                                batch_size=1)
    tx, _ = jsetup.build_optimizer(cfg_j, steps_per_epoch=1)
    params, opt_state = jstate.params, tx.init(jstate.params)
    tstate = tsetup.build_state(cfg_t, device="cpu", steps_per_epoch=1)
    tstate.load(train_state_from_jax(jax.device_get(jstate)))
    rng = np.random.default_rng(3)
    named = dict(tstate.model.named_parameters())
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: (rng.normal(size=p.shape)
                       * 10.0 ** rng.uniform(-9, 0, p.shape)).astype(
                           np.float32), jax.device_get(params))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        for k, g in params_from_jax(grads).items():
            named[k].grad = g
        tstate.optimizer.step()
        tstate.scheduler.step()
        want_p = params_from_jax(jax.device_get(params))
        want_mu = params_from_jax(jax.device_get(opt_state[0].mu))
        want_nu = params_from_jax(jax.device_get(opt_state[0].nu))
        for k, p in named.items():
            st = tstate.optimizer.state[p]
            for got, want in ((st["exp_avg"], want_mu[k]),
                              (st["exp_avg_sq"], want_nu[k])):
                want = want.numpy()
                np.testing.assert_allclose(
                    got.numpy(), want, rtol=0,
                    atol=1e-6 * np.abs(want).max(), err_msg=k)
            np.testing.assert_allclose(p.detach().numpy(), want_p[k].numpy(),
                                       rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("i", range(len(PLAN)))
def test_prototypes_match(run, i):
    rec = run["record"][i]
    got, want = rec["port"]["protos"].numpy(), rec["jax"]["protos"]
    print(f"step {i}: prototypes max abs err {np.abs(got - want).max():.3e}")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if rec["contrast"]:
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                                   rtol=1e-5)


def test_state_step_and_schedule(run):
    tstate = run["tstate"]
    assert tstate.step == int(run["jstate"].step) == len(PLAN)
    cfg = run["cfg_t"]
    sched = warmup_cosine_schedule(cfg.train.lr, cfg.train.warmup_epochs,
                                   cfg.train.n_epochs)
    assert tstate.optimizer.param_groups[0]["lr"] == pytest.approx(
        sched(len(PLAN)), rel=1e-12)
    _, jsched = jsetup.build_optimizer(run["cfg_j"], steps_per_epoch=1)
    for s in (0, 1, 2, 50, 99, 100, 150):
        assert sched(s) == pytest.approx(float(jsched(s)), rel=1e-6, abs=1e-9)


@pytest.mark.parametrize("use_knn", [False, True])
def test_eval_step_matches(run, use_knn):
    jeval = jax.jit(jstep.make_eval_step(run["cfg_j"], use_knn=use_knn))
    teval = tstep.make_eval_step(run["cfg_t"], use_knn=use_knn)
    want = jeval(run["jstate"], run["jb"])
    got = teval(run["tstate"], run["tb"])
    np.testing.assert_array_equal(got["argmax_2d"].numpy(),
                                  np.asarray(want["argmax_2d"]))
    np.testing.assert_array_equal(got["confusion"].numpy(),
                                  np.asarray(want["confusion"]))


def test_eval_step_crf_and_ddp_parity_raise():
    cfg = preset("tiny")
    with pytest.raises(NotImplementedError, match="item 16"):
        tstep.make_eval_step(cfg, use_crf=True)
    ddp = dataclasses.replace(cfg, contrast=dataclasses.replace(
        cfg.contrast, ddp_parity_protos=True))
    with pytest.raises(NotImplementedError, match="item 15"):
        tstep.make_train_step(ddp, tsetup.build_alpha(ddp), with_contrast=True)


def test_select_ratio_schedule_matches():
    for n in (10, 100):
        want = jstep.select_ratio_schedule(n)
        got = tstep.select_ratio_schedule(n)
        for epoch in (0, 5, n - 1):
            assert got(epoch) == want(epoch)


def test_step_draws_its_own_noise_and_frozen_memory():
    """With noise=None the step draws from the state's generator (same seed,
    same result); with use_prototype off the memory stays frozen."""
    cfg = _no_dropout(preset("tiny"))
    host = synthetic_batch(np.random.default_rng(1), cfg, 1, n_points=2000,
                           weak_ratio=0.02)
    batch = tstep.batch_to_device(host, torch.device("cpu"))
    step = tstep.make_train_step(cfg, tsetup.build_alpha(cfg),
                                 with_contrast=True)
    outs = []
    for _ in range(2):
        state = tsetup.build_state(cfg, device="cpu", seed=4,
                                   steps_per_epoch=1)
        state, m = step(state, batch, RATIO)
        outs.append((state.prototypes, m["losses"]["contrast"]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    frozen = dataclasses.replace(cfg, contrast=dataclasses.replace(
        cfg.contrast, use_prototype=False))
    state = tsetup.build_state(frozen, device="cpu", seed=4)
    before = state.prototypes.clone()
    state, m = tstep.make_train_step(frozen, tsetup.build_alpha(frozen),
                                     with_contrast=True)(state, batch, RATIO)
    assert torch.equal(state.prototypes, before)
    assert float(m["diag"]["proto_drift"]) == 0.0


def _two_warmup_steps(cfg, batch, global_seed, generator_seed=None):
    """Two warmup steps (the first runs at lr 0) from build_state(seed=0),
    with torch's global generator seeded to ``global_seed`` first."""
    torch.manual_seed(global_seed)
    state = tsetup.build_state(cfg, device="cpu", seed=0, steps_per_epoch=1)
    if generator_seed is not None:
        state.generator.manual_seed(generator_seed)
    step = tstep.make_train_step(cfg, tsetup.build_alpha(cfg),
                                 with_contrast=False)
    losses = []
    for _ in range(2):
        state, m = step(state, batch)
        losses.append(float(m["losses"]["total"]))
    return state.model.state_dict(), losses


def test_dropout_draws_from_the_state_generator():
    """At dropout 0.2 the step's channel masks come from state.generator:
    two runs from one seed give equal parameters, BatchNorm statistics and
    losses whatever torch's global generator holds; another generator seed
    gives other masks, so other statistics and parameters."""
    cfg = preset("tiny")
    assert cfg.model.dropout_rate == pytest.approx(0.2)
    host = synthetic_batch(np.random.default_rng(2), cfg, 2, n_points=2000,
                           weak_ratio=0.02)
    batch = tstep.batch_to_device(host, torch.device("cpu"))
    sd_a, loss_a = _two_warmup_steps(cfg, batch, global_seed=1)
    sd_b, loss_b = _two_warmup_steps(cfg, batch, global_seed=99)
    assert loss_a == loss_b
    for k in sd_a:
        assert torch.equal(sd_a[k], sd_b[k]), k
    sd_c, loss_c = _two_warmup_steps(cfg, batch, global_seed=1,
                                     generator_seed=12345)
    assert loss_c != loss_a
    differ = [k for k in sd_a if not torch.equal(sd_a[k], sd_c[k])]
    assert any(k.endswith("weight") for k in differ)
    assert any("running" in k for k in differ)


def test_dropout_needs_a_generator_in_training():
    from coarse3d_tpu_torch.models.blocks import Dropout2d

    drop = Dropout2d(0.5).train()
    x = torch.ones(3, 64, 2, 2)
    with pytest.raises(ValueError, match="generator"):
        drop(x)
    y = drop(x, torch.Generator().manual_seed(0))
    kept = y[:, :, 0, 0]
    # whole channels, kept ones scaled by 1/(1 - p)
    assert set(torch.unique(kept).tolist()) == {0.0, 2.0}
    assert torch.equal(y, kept[:, :, None, None].expand_as(y))
    assert torch.equal(drop.eval()(x), x)
