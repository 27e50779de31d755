"""The port's checkpoints (coarse3d_tpu_torch.train.checkpoint), on the CPU.

A checkpoint is written with torch.save and read back into a fresh state:
everything round-trips exactly (bit for bit): parameters, BatchNorm
statistics, Adam moments and step counts, prototypes, ``step``, the learning
rate, and the generator, whose next draw equals the unbroken run's. The JAX
package's manager (Orbax) is held to the same behaviour by
tests/test_trainer.py: rolling keeps two, best per metric key, the CLI
spellings of ``restore_from_run_dir``, the filtered pretrained load.
"""

import os

import numpy as np
import pytest
import torch

from coarse3d_tpu.models import salsanext as jsalsa
from coarse3d_tpu_torch.configs import preset
from coarse3d_tpu_torch.data.synthetic import synthetic_batch
from coarse3d_tpu_torch.models.salsanext import ENCODER_PREFIXES
from coarse3d_tpu_torch.tools.convert_jax_params import salsanext_entries
from coarse3d_tpu_torch.train.checkpoint import (
    CheckpointManager,
    load_pretrained_params,
    restore_from_run_dir,
)
from coarse3d_tpu_torch.train.setup import build_alpha, build_state
from coarse3d_tpu_torch.train.step import batch_to_device, make_train_step


@pytest.fixture(scope="module")
def trained():
    """A tiny state after one warmup and one contrast step, and its batch."""
    cfg = preset("tiny")
    state = build_state(cfg, device="cpu", seed=3, steps_per_epoch=4)
    batch = batch_to_device(synthetic_batch(
        np.random.default_rng(0), cfg, 2, n_points=2000, weak_ratio=0.01),
        torch.device("cpu"))
    alpha = build_alpha(cfg)
    steps = {wc: make_train_step(cfg, alpha, with_contrast=wc)
             for wc in (False, True)}
    steps[False](state, batch)
    steps[True](state, batch, 0.3)
    return cfg, state, batch, steps


def _fresh(cfg, seed=9):
    return build_state(cfg, device="cpu", seed=seed, steps_per_epoch=4)


def _assert_same_state(got, want):
    for (k, a), b in zip(got.model.state_dict().items(),
                         want.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert any("running_var" in k for k in got.model.state_dict())
    gp, wp = list(got.model.parameters()), list(want.model.parameters())
    for a, b in zip(gp, wp):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(got.optimizer.state[a][key],
                               want.optimizer.state[b][key]), key
        assert got.optimizer.state[a]["step"].device.type == "cpu"
    assert torch.equal(got.prototypes, want.prototypes)
    assert got.step == want.step == 2
    assert (got.optimizer.param_groups[0]["lr"]
            == want.optimizer.param_groups[0]["lr"] > 0)
    assert got.scheduler.last_epoch == want.scheduler.last_epoch == 2
    assert torch.equal(got.generator.get_state(), want.generator.get_state())


def test_round_trip_is_exact(trained, tmp_path):
    cfg, state, batch, steps = trained
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_rolling(state, 7)
    assert sorted(os.listdir(mgr.root)) == ["epoch_0007.pth"]   # no temp file
    fresh = _fresh(cfg)
    restored, start = mgr.restore(fresh)
    assert restored is fresh and start == 8
    _assert_same_state(restored, state)


def test_resumed_step_equals_the_unbroken_one(trained, tmp_path):
    """One more contrast step (dropout 0.2, noise and masks drawn from the
    generator) from the restored state and from the original: the same
    losses, parameters and memory, bit for bit."""
    cfg, state, batch, steps = trained
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_rolling(state, 0)
    restored, _ = mgr.restore(_fresh(cfg))
    out = []
    for st in (restored, state):
        _, m = steps[True](st, batch, 0.3)
        out.append((m, st))
    (m_a, a), (m_b, b) = out
    for k in m_b["losses"]:
        assert torch.equal(m_a["losses"][k], m_b["losses"][k]), k
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)
    assert torch.equal(a.prototypes, b.prototypes)
    assert torch.equal(torch.rand(3, generator=a.generator),
                       torch.rand(3, generator=b.generator))


def test_rolling_keeps_two(trained, tmp_path):
    cfg, state, _, _ = trained
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_epoch() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(_fresh(cfg))
    for epoch in range(4):
        mgr.save_rolling(state, epoch)
        assert mgr.latest_epoch() == epoch
    assert sorted(os.listdir(mgr.root)) == ["epoch_0002.pth",
                                            "epoch_0003.pth"]
    _, start = mgr.restore(_fresh(cfg), epoch=2)
    assert start == 3
    assert CheckpointManager(str(tmp_path), max_to_keep=1).latest_epoch() == 3
    mgr.close()


def test_best_tracking(trained, tmp_path):
    cfg, state, _, _ = trained
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.save_best(state, 0, {"3DIOU": 0.5}) == ["3DIOU"]
    other = _fresh(cfg, seed=5)
    assert mgr.save_best(other, 1, {"3DIOU": 0.4}) == []
    assert mgr.save_best(state, 2, {"3DIOU": 0.6, "3DAcc": 0.1}) == [
        "3DIOU", "3DAcc"]
    assert mgr.save_best(other, 3, {"3DIOU": 0.6, "3DAcc": 0.2}) == ["3DAcc"]
    assert sorted(os.listdir(mgr.root)) == ["best_3DAcc.pth", "best_3DIOU.pth"]
    got = mgr.restore_best(_fresh(cfg), key="3DIOU")
    for a, b in zip(got.model.parameters(), state.model.parameters()):
        assert torch.equal(a, b)
    got = mgr.restore_best(_fresh(cfg), key="3DAcc")
    for a, b in zip(got.model.parameters(), other.model.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(FileNotFoundError, match="best_nope"):
        mgr.restore_best(_fresh(cfg), key="nope")


@pytest.mark.parametrize("spelling", ["latest", "best_3DIOU", "3DIOU"])
def test_restore_from_run_dir_spellings(trained, tmp_path, spelling):
    cfg, state, _, _ = trained
    other = _fresh(cfg, seed=5)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_rolling(state, 0)
    mgr.save_best(other, 0, {"3DIOU": 0.3})
    want = state if spelling == "latest" else other
    got = restore_from_run_dir(_fresh(cfg), str(tmp_path), spelling)
    for a, b in zip(got.model.parameters(), want.model.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(got.prototypes, want.prototypes)


def test_generator_of_another_device_kind_is_left_alone(trained, tmp_path):
    """A checkpoint names the kind of device its generator lived on; a state
    on another kind keeps its own generator and restores the rest."""
    cfg, state, _, _ = trained
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_rolling(state, 0)
    path = os.path.join(mgr.root, "epoch_0000.pth")
    data = torch.load(path, weights_only=True)
    assert data["generator_device"] == "cpu"
    data["generator_device"] = "cuda"
    data["generator"] = torch.zeros(16, dtype=torch.uint8)
    torch.save(data, path)
    fresh = _fresh(cfg)
    before = fresh.generator.get_state()
    mgr.restore(fresh)
    assert torch.equal(fresh.generator.get_state(), before)
    assert torch.equal(fresh.prototypes, state.prototypes)


def test_load_pretrained_filtered(trained):
    cfg, donor, _, _ = trained
    state = _fresh(cfg)
    donor_sd = {k: v.clone() for k, v in donor.model.state_dict().items()}
    donor_sd["cls_head.weight"] = torch.zeros(3, 3)        # wrong shape
    donor_sd["not.in.model"] = torch.zeros(2)              # unknown name
    before = state.model.cls_head.weight.clone()
    new_state, copied = load_pretrained_params(state, donor_sd)
    assert new_state is state
    assert copied == len(donor.model.state_dict()) - 1 > 50
    assert torch.equal(state.model.cls_head.weight, before)
    assert torch.equal(state.model.downCntx.conv1.weight,
                       donor.model.downCntx.conv1.weight)
    assert torch.equal(state.model.resBlock1.bn1.running_var,
                       donor.model.resBlock1.bn1.running_var)
    # prefix filtering copies a strict subset: the encoder, not the decoder
    state2 = _fresh(cfg)
    up_before = state2.model.upBlock1.conv1.weight.clone()
    _, copied_enc = load_pretrained_params(state2, donor_sd,
                                           only_prefixes=ENCODER_PREFIXES)
    assert 0 < copied_enc < copied
    assert torch.equal(state2.model.upBlock1.conv1.weight, up_before)
    assert torch.equal(state2.model.resBlock3.conv2.weight,
                       donor.model.resBlock3.conv2.weight)


def test_encoder_prefixes_name_the_same_layers_as_jax():
    """The port's prefixes (reference module names) select exactly the
    layers the JAX package's prefixes (Flax scopes) select."""
    entries = salsanext_entries()
    port = {t for _, t, _ in entries if t.startswith(ENCODER_PREFIXES)}
    jax_ = {t for _, t, path in entries
            if path[0].startswith(jsalsa.ENCODER_PREFIXES)}
    assert port == jax_ and 0 < len(port) < len(entries)
