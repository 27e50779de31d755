"""The port's data parallelism (coarse3d_tpu_torch.parallel and the
``mesh`` paths of the training step, BatchNorm, the losses, the prototype
memory, the Trainer and the CLIs) on the CPU: two gloo processes
(``torch.multiprocessing.spawn``) at the tiny preset, against one process
on the concatenated batch and against the JAX package.

Two spawns hold every two-process case: one for the step and its parts,
one for the CLIs (``--multihost`` under torchrun's environment). The
global batch is B=4, each rank's stripe B=2, in rank order. The one
process runs the same program over a group of one, on one thread as the
ranks do; tests/test_torch_mesh_step.py holds that group of one against
JAX's ``make_train_step`` over ``make_mesh(2)`` and the plain step.

Tolerances:
- two processes against one, as tests/test_multichip.py:44-70 holds JAX's
  sharded step against its unsharded one: losses rtol 1e-4, confusion
  exact, parameters rtol 1e-3 / atol 1e-5 (where Adam's step is not the
  sign of a rounding: ``_close_params``), and their gradients; BatchNorm
  running statistics rtol 1e-5 / atol 1e-6, prototypes atol 1e-6; the two
  ranks' parameters and memories bit-identical;
- SyncBN against Flax's BatchNorm on the global batch: outputs atol 1e-5,
  running statistics rtol 1e-5 / atol 1e-6; its input gradient against one
  process within 1e-6;
- ``ddp_parity`` against JAX's ``update_prototypes_ddp_parity`` on
  ``make_mesh(2)`` with the Gumbel JAX draws from ``fold_in(key, rank)``:
  atol 1e-5;
- the gathered Lovász loss: the ranks' shares sum to the one-process value
  (rtol 1e-6) and each rank's gradient is its stripe of the one-process
  gradient (atol 1e-7);
- striped dropout masks and entropy selection: exactly the global draw's
  stripe;
- ``evaluate --multihost``: the confusion matrix count for count;
  ``train_crf --multihost`` against one process: kernel atol 1e-5.
"""

import dataclasses
import json
import os
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from coarse3d_tpu_torch.configs import preset
from coarse3d_tpu_torch.data.synthetic import synthetic_batch
from coarse3d_tpu_torch.losses.entropy_selection import entropy_based_selection
from coarse3d_tpu_torch.losses.lovasz import lovasz_softmax_loss
from coarse3d_tpu_torch.models import blocks
from coarse3d_tpu_torch.models.prototypes import update_prototypes_ddp_parity
from coarse3d_tpu_torch.parallel import destroy_mesh, make_mesh
from coarse3d_tpu_torch.parallel.mesh import (
    Mesh,
    replicate_to_mesh,
    shard_batch,
)
from coarse3d_tpu_torch.train import setup as tsetup
from coarse3d_tpu_torch.train import step as tstep
from coarse3d_tpu_torch.train.trainer import Trainer

WORLD = 2
B = 4                       # global batch; each rank holds B // WORLD
RATIO = 0.3
BN_MOMENTA = (0.1, 0.01)    # SalsaNext / SqueezeSegV3's SAC, RangeNet
LOVASZ_BUDGET = 50          # below rank 0's valid pixels: the budget cuts


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _cfg(dropout: bool = True, **contrast):
    cfg = preset("tiny")
    if not dropout:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, dropout_rate=0.0))
    return dataclasses.replace(cfg, contrast=dataclasses.replace(
        cfg.contrast, **contrast))


def _stripe(x, rank):
    n = x.shape[0] // WORLD
    return x[rank * n:(rank + 1) * n]


def _batch(host, rank=0, mesh=None):
    """The whole batch, or with a mesh the rank's stripe through
    ``shard_batch``."""
    if mesh is None:
        return tstep.batch_to_device(host, torch.device("cpu"))
    n = B // mesh.world
    return shard_batch({k: v[rank * n:(rank + 1) * n] for k, v in
                        host.items()}, mesh)


def _record(state, metrics):
    return {"losses": {k: float(v) for k, v in metrics["losses"].items()},
            "confusion": metrics["confusion"].clone(),
            "params": {k: v.detach().clone()
                       for k, v in state.model.named_parameters()},
            "buffers": {k: v.clone() for k, v in
                        state.model.state_dict().items() if "running" in k},
            "mu": {k: state.optimizer.state[p]["exp_avg"].clone()
                   for k, p in state.model.named_parameters()},
            "protos": state.prototypes.clone()}


def _run_steps(inputs, rank=0, mesh=None):
    """The step cases on one rank's stripe (with ``mesh``) or on the whole
    batch (one process): a contrast step from a carried JAX state with
    JAX's noise (when ``inputs`` holds one), a warmup and a contrast step
    drawing their own noise and dropout, and over two ranks a ddp_parity
    contrast step."""
    out = {}
    batch = _batch(inputs["batch"], rank, mesh)
    if "carried" in inputs:
        cfg0 = _cfg(dropout=False)
        state = tsetup.build_state(cfg0, device="cpu", steps_per_epoch=1)
        state.load(inputs["carried"])
        if mesh is not None:
            replicate_to_mesh(state, mesh)
        step = tstep.make_train_step(cfg0, tsetup.build_alpha(cfg0),
                                     with_contrast=True, mesh=mesh)
        state, m = step(state, batch, RATIO, inputs["noise"])
        out["carried"] = _record(state, m)

    cfg = _cfg()
    state = tsetup.build_state(cfg, device="cpu", steps_per_epoch=1)
    if mesh is not None:
        replicate_to_mesh(state, mesh)
    for i, wc in enumerate((False, True)):
        step = tstep.make_train_step(cfg, tsetup.build_alpha(cfg),
                                     with_contrast=wc, mesh=mesh)
        state, m = step(state, batch, RATIO)
        out[f"drawn_{i}"] = _record(state, m)
    out["generator"] = state.generator.get_state()

    if mesh is not None and mesh.world > 1:
        pcfg = _cfg(ddp_parity_protos=True, proto_momentum=0.5)
        state = tsetup.build_state(pcfg, device="cpu", steps_per_epoch=1)
        replicate_to_mesh(state, mesh)
        step = tstep.make_train_step(pcfg, tsetup.build_alpha(pcfg),
                                     with_contrast=True, mesh=mesh)
        before = state.prototypes.clone()
        state, m = step(state, batch, RATIO)
        out["ddp_step"] = {"loss": float(m["losses"]["total"]),
                           "before": before, "after": state.prototypes}
    return out


def _run_parts(inputs, rank, mesh):
    """SyncBN, the gathered Lovász loss and the ddp_parity update alone."""
    out = {}
    for mom in BN_MOMENTA:
        bn = blocks.batch_norm(inputs["bn_x"].shape[1], mom).train()
        bn.mesh = mesh
        x = _stripe(inputs["bn_x"], rank).clone().requires_grad_()
        y = bn(x)
        (y * _stripe(inputs["bn_w"], rank)).sum().backward()
        out[f"bn_{mom}"] = {"y": y.detach(), "grad": x.grad,
                            "mean": bn.running_mean.clone(),
                            "var": bn.running_var.clone()}
    probs = _stripe(inputs["lov_probs"], rank).clone().requires_grad_()
    loss = lovasz_softmax_loss(probs, _stripe(inputs["lov_labels"], rank),
                               budget=LOVASZ_BUDGET, mesh=mesh)
    loss.backward()
    out["lovasz"] = {"share": float(loss), "grad": probs.grad}
    d = inputs["ddp"]
    ccfg = _cfg(proto_momentum=0.5).contrast
    out["ddp_update"] = update_prototypes_ddp_parity(
        d["protos"], _stripe(d["emb"], rank), _stripe(d["lbl"], rank),
        _stripe(d["msk"], rank), d["gumbel"][rank], ccfg, mesh)
    try:
        Trainer(_cfg(), _Steps(1 + rank), None, device="cpu", mesh=mesh)
    except ValueError as err:
        out["uneven"] = str(err)
    return out


class _Steps:
    """A training pipeline that only counts its steps."""

    def __init__(self, n: int):
        self.n = n

    def steps_per_epoch(self) -> int:
        return self.n


def _step_worker(rank, port, tmp):
    torch.set_num_threads(1)
    mesh = make_mesh("cpu", init_method=f"tcp://localhost:{port}",
                     rank=rank, world_size=WORLD)
    try:
        inputs = torch.load(os.path.join(tmp, "inputs.pt"),
                            weights_only=False)
        out = _run_steps(inputs, rank, mesh)
        out.update(_run_parts(inputs, rank, mesh))
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        destroy_mesh()


def _cli_worker(rank, ports, tmp, argvs):
    """Each CLI under torchrun's environment, one port per process group."""
    from coarse3d_tpu_torch.tools import evaluate, train, train_crf

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(WORLD), MASTER_ADDR="localhost")
    results = {}
    for (name, argv), port in zip(argvs, ports):
        os.environ["MASTER_PORT"] = str(port)
        tool = {"train": train, "evaluate": evaluate,
                "train_crf": train_crf}[name]
        got = tool.main(argv + ["--multihost"])
        if name == "train":
            got = {"params": {k: v.detach().clone() for k, v in
                              got.state.model.state_dict().items()},
                   "protos": got.state.prototypes.clone(),
                   "history": got.history}
        results[name] = got
    torch.save(results, os.path.join(tmp, f"cli{rank}.pt"))


# -- the step and its parts: two processes, one process, JAX -----------------------

def _inputs():
    """The global batch, and the inputs of the parts with JAX's
    ddp_parity result on make_mesh(2)."""
    import jax
    import jax.numpy as jnp

    from coarse3d_tpu.parallel import make_mesh as jax_mesh

    cfg = _cfg()
    host = synthetic_batch(np.random.default_rng(0), cfg, B, n_points=3000,
                           weak_ratio=0.01)
    _, h, w = host["train_label"].shape
    mesh = jax_mesh(WORLD)
    jax_out = {}
    rng = np.random.default_rng(5)
    c = cfg.data.n_classes
    ccfg = _cfg(proto_momentum=0.5).contrast
    k, d, m = ccfg.sub_proto_size, ccfg.proj_dim, ccfg.max_pixels_per_class
    lbl = rng.integers(0, c, (B, h, w)).astype(np.int32)
    ddp = {"protos": rng.normal(size=(c, k, d)).astype(np.float32),
           "emb": rng.normal(size=(B, h, w, d)).astype(np.float32),
           "lbl": lbl, "msk": lbl > 0}
    key = jax.random.key(7)
    ddp["gumbel"] = np.stack([
        np.stack([np.asarray(jax.random.gumbel(r, (m, k), jnp.float32))
                  for r in jax.random.split(jax.random.fold_in(key, i), c)])
        for i in range(WORLD)])
    jax_out["ddp_update"] = _jax_ddp_parity(ddp, key, ccfg, mesh)
    inputs = {
        "batch": host,
        "bn_x": torch.from_numpy(rng.normal(
            1.5, 2.0, (B, 6, 5, 7)).astype(np.float32)),
        "bn_w": torch.from_numpy(rng.normal(size=(B, 6, 5, 7)).astype(
            np.float32)),
        "lov_probs": torch.softmax(torch.from_numpy(rng.normal(
            size=(B, h, w, c)).astype(np.float32)), dim=-1),
        "lov_labels": torch.from_numpy(
            rng.integers(0, c, (B, h, w)) * (rng.random((B, h, w)) < 0.05)),
        "ddp": {k2: torch.from_numpy(np.asarray(v)) for k2, v in ddp.items()},
    }
    return inputs, jax_out


def _jax_ddp_parity(ddp, key, ccfg, mesh):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from coarse3d_tpu.configs.config import ContrastConfig
    from coarse3d_tpu.models.prototypes import update_prototypes_ddp_parity

    jcfg = ContrastConfig(**dataclasses.asdict(ccfg))
    shard = lambda x: jax.device_put(jnp.asarray(x),  # noqa: E731
                                     NamedSharding(mesh, P("data")))
    got = jax.jit(lambda *a: update_prototypes_ddp_parity(
        a[0], a[1], a[2], a[3], a[4], jcfg, mesh=mesh))(
            jax.device_put(jnp.asarray(ddp["protos"]),
                           NamedSharding(mesh, P())),
            shard(ddp["emb"]), shard(ddp["lbl"]), shard(ddp["msk"]), key)
    return np.asarray(got)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("parallel"))
    inputs, jax_out = _inputs()
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    mp.spawn(_step_worker, args=(_free_port(), tmp), nprocs=WORLD,
             join=True)
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    return {"inputs": inputs, "jax": jax_out, "ranks": ranks,
            "one": run_one_process(inputs)[0]}


def run_one_process(inputs):
    """The step cases in this process: over a group of one (the same
    program as the ranks'), and plain. On one thread, as the ranks run: a
    convolution's rounding depends on how many threads split it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mesh = make_mesh("cpu", init_method=f"tcp://localhost:{_free_port()}",
                     rank=0, world_size=1)
    try:
        return _run_steps(inputs, mesh=mesh), _run_steps(inputs)
    finally:
        destroy_mesh()
        torch.set_num_threads(threads)


def _close_params(got, want):
    """Gradients (Adam's first moment) elementwise, rtol 1e-3 / atol 1e-5
    of the tensor's largest (a gradient sums many terms: its rounding is
    theirs, not its own size's); parameters rtol 1e-3 / atol 1e-5 where
    |moment| >= 1e-3 of the tensor's largest. Below that a gradient is
    within a few hundred roundings of 0 and Adam divides it by its own
    size, so the step is the rounding's sign, as
    tests/test_torch_train_step.py leaves such steps out too; so is a whole
    tensor whose largest moment is under 1e-6 (a gradient that is 0 but
    for rounding: a bias ahead of a BatchNorm)."""
    for k, w in want["params"].items():
        mu = want["mu"][k].numpy()
        top = float(np.abs(mu).max())
        if not top > 1e-6:
            continue
        np.testing.assert_allclose(got["mu"][k].numpy(), mu, rtol=1e-3,
                                   atol=1e-5 * top, err_msg=f"mu {k}")
        big = np.abs(mu) >= 1e-3 * top
        np.testing.assert_allclose(got["params"][k].numpy()[big],
                                   w.numpy()[big], rtol=1e-3, atol=1e-5,
                                   err_msg=k)


STEP_CASES = ("drawn_0", "drawn_1")


@pytest.mark.parametrize("case", STEP_CASES)
def test_two_processes_equal_one(two, case):
    """Losses, confusion, BatchNorm statistics, parameters and memory of
    the two-process step equal one process on the concatenated batch,
    including the noise and dropout masks the step draws itself."""
    want = two["one"][case]
    for rank, out in enumerate(two["ranks"]):
        got = out[case]
        assert set(got["losses"]) == set(want["losses"])
        for k, v in want["losses"].items():
            np.testing.assert_allclose(got["losses"][k], v, rtol=1e-4,
                                       err_msg=f"rank {rank} {k}")
        assert torch.equal(got["confusion"], want["confusion"])
        for k, v in want["buffers"].items():
            np.testing.assert_allclose(got["buffers"][k].numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got["protos"].numpy(),
                                   want["protos"].numpy(), rtol=0, atol=1e-6)
    _close_params(two["ranks"][0][case], want)


def test_ranks_hold_identical_state(two):
    """After every case both ranks hold the same parameters and the same
    memory, bit for bit (no broadcast after the start), and their
    generators stay in step."""
    r0, r1 = two["ranks"]
    for case in STEP_CASES:
        for k, v in r0[case]["params"].items():
            assert torch.equal(v, r1[case]["params"][k]), (case, k)
        assert torch.equal(r0[case]["protos"], r1[case]["protos"]), case
    assert torch.equal(r0["generator"], r1["generator"])
    assert torch.equal(r0["generator"], two["one"]["generator"])
    for a, b in zip(r0["ddp_step"].values(), r1["ddp_step"].values()):
        assert a == b if isinstance(a, float) else torch.equal(a, b)


@pytest.mark.parametrize("momentum", BN_MOMENTA)
def test_sync_batchnorm_matches_flax_on_the_global_batch(two, momentum):
    """Each rank's output stripe, and the running statistics (the BIASED
    variance folded in, as Flax folds it), equal Flax's BatchNorm on the
    whole batch; the input gradient through the all-reduce equals one
    process's."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    x = two["inputs"]["bn_x"]
    bn = fnn.BatchNorm(use_running_average=False, momentum=1.0 - momentum,
                       epsilon=1e-5)
    xj = jnp.asarray(x.permute(0, 2, 3, 1).numpy())
    variables = bn.init(jax.random.key(0), xj)
    y, upd = bn.apply(variables, xj, mutable=["batch_stats"])
    want_y = torch.from_numpy(np.asarray(y)).permute(0, 3, 1, 2)
    stats = upd["batch_stats"]

    one = blocks.batch_norm(x.shape[1], momentum).train()
    xo = x.clone().requires_grad_()
    (one(xo) * two["inputs"]["bn_w"]).sum().backward()
    for rank, out in enumerate(two["ranks"]):
        got = out[f"bn_{momentum}"]
        np.testing.assert_allclose(got["y"].numpy(),
                                   _stripe(want_y, rank).numpy(), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got["mean"].numpy(),
                                   np.asarray(stats["mean"]), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got["var"].numpy(),
                                   np.asarray(stats["var"]), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got["grad"].numpy(),
                                   _stripe(xo.grad, rank).numpy(), rtol=0,
                                   atol=1e-6)


def test_gathered_lovasz_equals_one_process(two):
    """The budget cuts across ranks (the global batch's first 100 valid
    pixels, all on rank 0): the ranks' shares sum to the one-process loss
    and each rank's gradient is its stripe of the one-process gradient."""
    probs = two["inputs"]["lov_probs"].clone().requires_grad_()
    labels = two["inputs"]["lov_labels"]
    assert int((labels[:B // WORLD] > 0).sum()) > LOVASZ_BUDGET
    want = lovasz_softmax_loss(probs, labels, budget=LOVASZ_BUDGET)
    want.backward()
    shares = [out["lovasz"]["share"] for out in two["ranks"]]
    np.testing.assert_allclose(sum(shares), float(want), rtol=1e-6)
    for rank, out in enumerate(two["ranks"]):
        np.testing.assert_allclose(out["lovasz"]["grad"].numpy(),
                                   _stripe(probs.grad, rank).numpy(),
                                   rtol=0, atol=1e-7)
    assert not two["ranks"][1]["lovasz"]["grad"].any()


def test_trainer_refuses_ranks_with_unequal_steps(two):
    """A rank whose training pipeline gives one step more would wait in
    collectives the others never enter: both ranks refuse at once."""
    for out in two["ranks"]:
        assert "1 to 2 steps" in out["uneven"]


def test_ddp_parity_matches_jax(two):
    """Per-rank update on the rank's stripe with the Gumbel JAX draws from
    fold_in(key, rank), then the mean over ranks with no renormalisation:
    equal to JAX's update_prototypes_ddp_parity on make_mesh(2), on both
    ranks; and the contrast step in this mode runs and moves the memory."""
    want = two["jax"]["ddp_update"]
    for out in two["ranks"]:
        np.testing.assert_allclose(out["ddp_update"].numpy(), want, rtol=0,
                                   atol=1e-5)
    norms = np.linalg.norm(want, axis=-1)
    assert not np.allclose(norms, 1.0, atol=1e-3)
    step = two["ranks"][0]["ddp_step"]
    assert np.isfinite(step["loss"])
    assert not torch.allclose(step["after"], step["before"])


# -- in one process: striped noise, world size one, backends ------------------------

def test_dropout_and_selection_take_the_global_draw_stripe():
    """Dropout2d with a two-rank mesh draws the global batch's masks and
    keeps its stripe; entropy selection on a stripe with the global batch
    size equals its stripe of the global selection."""
    g = torch.Generator().manual_seed(3)
    drop = blocks.Dropout2d(0.5).train()
    x = torch.ones(B, 8, 2, 2)
    whole = drop(x, torch.Generator().manual_seed(3))
    for rank in range(WORLD):
        drop.mesh = Mesh(rank=rank, world=WORLD, device=torch.device("cpu"))
        g.manual_seed(3)
        assert torch.equal(drop(_stripe(x, rank), g), _stripe(whole, rank))

    cfg = _cfg()
    host = synthetic_batch(np.random.default_rng(1), cfg, B, n_points=2000,
                           weak_ratio=0.02)
    batch = _batch(host)
    rng = np.random.default_rng(2)
    _, h, w = host["train_label"].shape
    probs = torch.softmax(torch.from_numpy(rng.normal(
        size=(B, h, w, 8)).astype(np.float32)), -1)
    gumbel = torch.from_numpy(rng.gumbel(size=B * h * w).astype(np.float32))
    args = (batch["train_label"] > 0, batch["eval_label"] > 0,
            batch["train_label"])
    want = entropy_based_selection(probs, *args, 0.4, gumbel)
    n = B // WORLD * h * w
    for rank in range(WORLD):
        got = entropy_based_selection(
            _stripe(probs, rank), *(_stripe(a, rank) for a in args), 0.4,
            gumbel[rank * n:(rank + 1) * n], global_batch=B)
        for a, b in zip(got, want):
            assert torch.equal(a, _stripe(b, rank))


@pytest.mark.parametrize("kwargs, error, match", [
    (dict(device="cpu", backend="nccl"), ValueError, "nccl"),
    (dict(device="cpu", backend="mpi"), ValueError, "unknown backend"),
    (dict(device="cpu", init_method="tcp://localhost:1"), ValueError,
     "rank and world_size"),
    (dict(device="cpu"), RuntimeError, "torchrun"),
])
def test_wrong_backend_or_device_raises(kwargs, error, match, monkeypatch):
    """NCCL on the CPU, an unknown backend, an explicit address without a
    rank, or no torchrun environment: each raises before any group starts,
    and nothing falls back."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    if kwargs.get("backend"):
        kwargs = dict(kwargs, init_method="tcp://localhost:1", rank=0,
                      world_size=1)
    with pytest.raises(error, match=match):
        make_mesh(**kwargs)
    assert not torch.distributed.is_initialized()


def test_cuda_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh("cuda", init_method="tcp://localhost:1", rank=0,
                  world_size=1)


# -- the CLIs under torchrun's environment --------------------------------------------

@pytest.fixture(scope="module")
def clis(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("clis"))
    run = os.path.join(tmp, "run")
    common = ["--preset", "tiny", "--device", "cpu", "--num_workers", "1",
              "--synthetic_points", "1500"]
    argvs = [
        ("train", common + ["--synthetic", "7", "--batch_size", "2",
                            "--epochs", "2", "--save_path", run,
                            "--set", "contrast.contrast_warmup=1"]),
        ("evaluate", common + ["--synthetic", "5", "--batch_size", "2",
                               "--knn", "--run_dir", run, "--summary_json",
                               os.path.join(tmp, "eval2.json")]),
        ("train_crf", common + ["--synthetic", "5", "--synthetic_task",
                                "bands", "--weak", "0.01", "--batch_size",
                                "2", "--epochs", "2", "--run_dir", run,
                                "--ckpt", "latest", "--out",
                                os.path.join(tmp, "crf2.npz")]),
    ]
    ports = [_free_port() for _ in argvs]
    mp.spawn(_cli_worker, args=(ports, tmp, argvs), nprocs=WORLD, join=True)
    ranks = [torch.load(os.path.join(tmp, f"cli{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    return {"tmp": tmp, "run": run, "argvs": dict(argvs), "ranks": ranks}


def test_train_multihost_runs(clis):
    """Two epochs (warmup, then contrast with the memory on gathered rows)
    through ``tools/train.py --multihost`` on 7 scans, which do not split
    evenly over two ranks: each rank takes the same one step an epoch (3
    scans of 6; the shuffled order's last scan is left out), the ranks end
    identical, rank 0 alone wrote the log and the checkpoints."""
    r0, r1 = (r["train"] for r in clis["ranks"])
    for k, v in r0["params"].items():
        assert torch.equal(v, r1["params"][k]), k
    assert torch.equal(r0["protos"], r1["protos"])
    assert [h["with_contrast"] for h in r0["history"] if h["mode"] == "Train"
            ] == [False, True]
    for r in (r0, r1):
        assert [h["steps"] for h in r["history"] if h["mode"] == "Train"
                ] == [1, 1]
    for h0, h1 in zip(r0["history"], r1["history"]):
        assert h0["3DIOU"] == h1["3DIOU"] and np.isfinite(h0["3DIOU"])
        np.testing.assert_array_equal(h0["confusion"], h1["confusion"])
    ckpts = os.listdir(os.path.join(clis["run"], "checkpoint"))
    assert "epoch_0001.pth" in ckpts
    assert not [f for f in ckpts if f.endswith(".tmp")]


def test_evaluate_multihost_counts_like_one_process(clis):
    from coarse3d_tpu_torch.tools import evaluate

    got = [r["evaluate"] for r in clis["ranks"]]
    want = evaluate.main(clis["argvs"]["evaluate"][:-2])
    assert got[0]["confusion"] == got[1]["confusion"] == want["confusion"]
    assert sum(map(sum, want["confusion"])) == 5 * 1500
    with open(os.path.join(clis["tmp"], "eval2.json")) as f:
        assert json.load(f)["confusion"] == want["confusion"]


def test_train_crf_multihost_fits_the_one_process_kernel(clis, tmp_path):
    """Two processes on stripes of 3 and 2 scans (the shorter one joins the
    last step with no weak label) fit the kernel one process fits on
    batches of 4."""
    from coarse3d_tpu_torch.tools import train_crf

    argv = list(clis["argvs"]["train_crf"])
    argv[argv.index("--batch_size") + 1] = "4"
    argv[argv.index("--out") + 1] = str(tmp_path / "crf1.npz")
    want = train_crf.main(argv)
    for r in clis["ranks"]:
        np.testing.assert_allclose(r["train_crf"]["kernel"], want["kernel"],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(r["train_crf"]["history"],
                                   want["history"], rtol=1e-4)
    assert os.path.isfile(os.path.join(clis["tmp"], "crf2.npz"))
