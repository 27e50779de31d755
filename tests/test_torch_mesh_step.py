"""The port's training step over a process group of one
(coarse3d_tpu_torch.parallel, gloo on the CPU) against the JAX package's
``make_train_step`` over ``make_mesh(2)`` (its sharded step), and against
the port's plain step, at the tiny preset on a global batch of B=4.

tests/test_torch_parallel.py holds two processes equal to this group of
one; here the group of one is held against JAX, as
tests/test_torch_train_step.py holds the port against JAX
(``_like_another_program``: two programs that round differently), and
against the plain step, which is the same program: bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_parallel import B, RATIO, WORLD, _cfg, run_one_process
from coarse3d_tpu_torch.data.synthetic import synthetic_batch

STEP_CASES = ("carried", "drawn_0", "drawn_1")


@pytest.fixture(scope="module")
def steps():
    """JAX's contrast step over make_mesh(2) from its state moved to step 1
    (every optimizer count 1, zero moments: the full learning rate, and
    one compile), and the port's step cases from that state with JAX's
    noise, over a group of one and plain."""
    import jax
    import jax.numpy as jnp

    from coarse3d_tpu.configs import preset as jax_preset
    from coarse3d_tpu.parallel import make_mesh as jax_mesh
    from coarse3d_tpu.parallel import replicate_to_mesh as jax_replicate
    from coarse3d_tpu.parallel import shard_batch as jax_shard
    from coarse3d_tpu.train import setup as jsetup
    from coarse3d_tpu.train import step as jstep
    from coarse3d_tpu_torch.tools.convert_jax_params import (
        state_dict_from_jax,
        train_state_from_jax,
    )
    from tests.test_torch_train_step import _jax_noise, _snapshot_jax

    cfg_j = jax_preset("tiny")
    cfg_j = dataclasses.replace(cfg_j, model=dataclasses.replace(
        cfg_j.model, dropout_rate=0.0))
    host = synthetic_batch(np.random.default_rng(0), _cfg(), B,
                           n_points=3000, weak_ratio=0.01)
    _, h, w = host["train_label"].shape
    mesh = jax_mesh(WORLD)
    jstate = jsetup.build_state(cfg_j, jax.random.key(0), steps_per_epoch=1,
                                batch_size=B)
    jstate = jstate.replace(step=jnp.ones_like(jstate.step),
                            opt_state=jax.tree_util.tree_map_with_path(
                                lambda path, x: (jnp.ones_like(x) if str(
                                    path[-1]) == ".count" else x),
                                jstate.opt_state))
    inputs = {"batch": host,
              "carried": train_state_from_jax(jax.device_get(jstate)),
              "noise": _jax_noise(jstate.rng, cfg_j, B, h, w)}
    step = jax.jit(jstep.make_train_step(cfg_j, jsetup.build_alpha(cfg_j),
                                         with_contrast=True))
    jstate, jm = step(jax_replicate(jstate, mesh), jax_shard(host, mesh),
                      RATIO)
    stats = state_dict_from_jax(jax.device_get(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    snap = _snapshot_jax(jstate)
    jax_out = {
        "losses": {k: float(v) for k, v in jm["losses"].items()},
        "confusion": np.asarray(jm["confusion"]),
        "buffers": {k: v for k, v in stats.items() if "running" in k},
        "protos": snap["protos"], "mu": snap["mu"],
        "params": snap["params"]}
    one, plain = run_one_process(inputs)
    return {"jax": jax_out, "one": one, "plain": plain}


def _like_another_program(got, want):
    """Two programs that round differently (tests/test_torch_train_step.py):
    losses rtol 1e-4, confusion exact, BatchNorm statistics rtol 1e-5,
    memory atol 1e-5; gradients (Adam's first moment, atol 1e-7) and
    parameters (atol 1e-6, where the moment is ten times 1e-7)
    elementwise where no leaky-ReLU kink lies on the way (KINK_FREE), by
    direction (cosine >= 0.9) and norm (within 10 %) elsewhere."""
    from tests.test_torch_train_step import KINK_FREE

    mu_atol, param_atol = 1e-7, 1e-6
    assert set(got["losses"]) == set(want["losses"])
    for k, v in want["losses"].items():
        np.testing.assert_allclose(got["losses"][k], v, rtol=1e-4, err_msg=k)
    np.testing.assert_array_equal(np.asarray(got["confusion"]),
                                  np.asarray(want["confusion"]))
    for k, v in got["buffers"].items():
        np.testing.assert_allclose(
            v.numpy(), np.asarray(want["buffers"][k]), rtol=1e-5,
            atol=1e-5 if k.endswith("running_mean") else 0, err_msg=k)
    np.testing.assert_allclose(got["protos"].numpy(),
                               np.asarray(want["protos"]), rtol=0, atol=1e-5)
    for k, w in want["mu"].items():
        g, w = got["mu"][k].numpy().ravel(), np.asarray(w).ravel()
        if k in KINK_FREE:
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=mu_atol,
                                       err_msg=f"mu {k}")
            big = np.abs(w) >= 10 * mu_atol
            np.testing.assert_allclose(
                got["params"][k].numpy().ravel()[big],
                np.asarray(want["params"][k]).ravel()[big], rtol=0,
                atol=param_atol, err_msg=k)
        elif np.abs(w).max() > 1e-6:
            cos = float(g @ w / (np.linalg.norm(g) * np.linalg.norm(w)))
            ratio = float(np.linalg.norm(g) / np.linalg.norm(w))
            assert cos >= 0.9 and abs(ratio - 1) <= 0.1, (k, cos, ratio)


def test_one_process_step_matches_jax_on_a_mesh(steps):
    """The port's contrast step over a group of one on the global batch
    against ``make_train_step`` over ``make_mesh(2)``, from the same
    carried state with the same noise."""
    _like_another_program(steps["one"]["carried"], steps["jax"])


@pytest.mark.parametrize("case", STEP_CASES)
def test_world_size_one_matches_the_plain_step(steps, case):
    """Over a group of one the step runs the plain step's program: the
    BatchNorm statistics gather nothing, the losses' global counts and
    gathered rows are the local ones, the global noise is the local noise.
    The two give the same losses, confusion, BatchNorm statistics,
    gradients, parameters and memory, bit for bit (chip_smoke.py holds the
    same on the card)."""
    got, want = steps["one"][case], steps["plain"][case]
    assert got["losses"] == want["losses"]
    assert torch.equal(got["confusion"], want["confusion"])
    for part in ("buffers", "mu", "params"):
        for k, v in want[part].items():
            assert torch.equal(got[part][k], v), (part, k)
    assert torch.equal(got["protos"], want["protos"])
