"""The port's top-level entry points (coarse3d_tpu_torch/entry.py) against the
JAX package's ``__graft_entry__.py``, on the CPU.

- ``entry``: both built at the ``tiny`` preset (float32; the ``kitti``
  preset's name patched to it on both sides), the JAX entry's variables
  carried across by ``state_dict_from_jax``; ``probs`` within atol 1e-4,
  the forward tolerance of tests/test_torch_salsanext.py.
- ``dryrun_multichip(2, device="cpu")``: one spawn of two gloo processes
  at the JAX dry run's configuration; it prints the JAX dry run's line.
  The JAX dry run itself (a multi-minute CPU compile of the sharded step)
  is not run: its checks are the ones the port's makes.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coarse3d_tpu_torch.tools.convert_jax_params import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_entry_forward_matches_jax(monkeypatch):
    import coarse3d_tpu.configs as jconfigs
    import coarse3d_tpu_torch.configs as tconfigs
    from coarse3d_tpu.train.setup import build_model
    from coarse3d_tpu_torch.entry import entry

    monkeypatch.syspath_prepend(REPO)
    import __graft_entry__

    for mod in (jconfigs, tconfigs):
        real = mod.preset
        monkeypatch.setattr(
            mod, "preset",
            lambda name, real=real: real("tiny" if name == "kitti" else name))
    jfn, (jx,) = __graft_entry__.entry()
    tfn, (tx,) = entry(device="cpu")
    assert tuple(tx.shape) == tuple(jx.shape) == (1, 16, 64, 5)
    assert tx.device.type == "cpu" and tx.dtype == torch.float32

    # the JAX entry's variables: its model initialised from key(0) on its
    # example input, as __graft_entry__.entry does
    cfg = jconfigs.preset("kitti")
    variables = build_model(cfg).init({"params": jax.random.key(0)}, jx,
                                      train=False, return_feat=True)
    tfn.model.load_state_dict(state_dict_from_jax(
        jax.device_get(variables)), strict=True)
    x = np.random.default_rng(0).normal(size=(1, 16, 64, 5)).astype(
        np.float32)
    want = np.asarray(jfn(jnp.asarray(x)))
    got = tfn(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 16, 64, cfg.data.n_classes)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_entry_defaults_to_the_card(monkeypatch):
    from coarse3d_tpu_torch.entry import dryrun_multichip, entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (entry, lambda: dryrun_multichip(2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_dryrun_multichip_two_gloo_ranks(monkeypatch, capsys):
    from coarse3d_tpu_torch.entry import dryrun_multichip

    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # read by the spawned ranks
    res = dryrun_multichip(2, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(
        r"dryrun_multichip\(2\): total_loss=\d+\.\d{4} conf_points=\d+ "
        r"parity_proto_norm=\d+\.\d{3} eval_conf_points=\d+ OK", line), line
    assert res["backend"] == "gloo"
    # every valid point of the two scans counted, in training and in eval
    assert res["conf"] == res["eval_conf"] == 2 * 1500
    # the per-rank update averages unit-norm rows: C*K rows, each <= 1
    assert 0 < res["pnorm"] <= np.sqrt(8 * 4) + 1e-4
    # no kernel launches on the CPU: the wrappers ran their plain twins
    assert res["launches"] == {"proj_scatter_min": 0, "knn_vote": 0,
                               "proto_tail": 0}
