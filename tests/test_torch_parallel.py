"""Data parallelism of the port (``greedy_multimodal_learning_tpu_torch/parallel``)
on the CPU: ranks are spawned processes in a gloo group (torch on one thread
each, every group with a 60 s timeout, every run with a deadline).

* one guided step at two ranks against the JAX package's two-device mesh
  step (``tests/test_parallel.py:18-86``): same weights through
  ``state_dict_from_jax``, same batches, JAX's flips fed in, momentum 0 and
  0.9; the losses of two steps within rtol 1e-4 and the parameters after
  one step within rtol 2e-2, atol 2e-4, JAX's own tolerances;
* two ranks against the one-process port on the same global batches, a
  last batch whose second rank holds padding only included: losses,
  accuracies and the controller within ``RANKS_TOL``, every parameter's
  update within ``UPDATE_TOL`` in L2, BatchNorm statistics and the MMTM
  running averages within ``RANKS_TOL``, and every rank's state equal to
  the other's, bit for bit; the same for one step of the 3-D family;
* the world-reduced masked BatchNorm on 4-D and 5-D maps against the
  one-process BatchNorm on the joined batch, forward, input and weight
  gradients and running statistics;
* at world 1 the data-parallel step is the plain step bit for bit, and
  issues collectives; the flips of two ranks join into the one-process
  draw.
"""

import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist

from greedy_multimodal_learning_tpu_torch import parallel
from greedy_multimodal_learning_tpu_torch.engine import Trainer, make_optimizer
from greedy_multimodal_learning_tpu_torch.engine.controller import ControllerState
from greedy_multimodal_learning_tpu_torch.models import MMTM3DCNN, MMTMMVCNN, BatchNorm2d, BatchNorm3d, init_parameters
from greedy_multimodal_learning_tpu_torch.parallel.launch import run_ranks
from greedy_multimodal_learning_tpu_torch.utils import prng

GROUP_TIMEOUT = datetime.timedelta(seconds=60)
RUN_TIMEOUT = 150.0  # seconds for every rank of a spawned run
B, V, IMG, NC = 8, 2, 32, 4  # tests/test_parallel.py's shapes
LR, EPSILON, WINDOW = 0.1, 0.01, 5
# Two ranks against one process: the same f32 arithmetic with the batch sums
# split in two, so forward quantities agree to rounding.
RANKS_TOL = (1e-5, 1e-6)
# A parameter's update, ||ranks - one||_2 <= UPDATE_TOL * ||update||_2: the
# gradients are sums split across ranks, ~1e-6 relative.
UPDATE_TOL = 1e-3
# JAX's own tolerances for its sharded step (tests/test_parallel.py:82-86).
JAX_LOSS_RTOL = 1e-4
JAX_PARAM_TOL = (2e-2, 2e-4)
FIELDS = ("M_main", "M_bypass", "curation_mode", "caring_modality", "curation_step", "d_BDR")


def _join_gloo():
    """This spawned rank in a gloo group of torchrun's environment."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://", timeout=GROUP_TIMEOUT)
    return parallel.world_from_process_group()


def _trainer(model, momentum, world):
    return Trainer(
        model,
        make_optimizer(model.parameters(), lr=LR, momentum=momentum),
        nummodalities=model.num_towers,
        controller_kind="guided",
        controller_config={"epsilon": EPSILON, "curation_windowsize": WINDOW},
        device="cpu",
        world=world,
    )


def _model(family):
    """``2d``, ``3d``, or ``2d_remat``: the 2-D family with every block
    recomputed in the backward (its recompute issues the BatchNorm sums
    again and leaves the running statistics alone)."""
    if family == "3d":
        return MMTM3DCNN(nclasses=NC, width_multiplier=0.25).to(memory_format=torch.channels_last_3d)
    return MMTMMVCNN(nclasses=NC, remat=family == "2d_remat").to(memory_format=torch.channels_last)


def _start(model, trainer):
    """What a step starts from: the model's state, the controller and SGD's
    momentum buffers, by parameter name."""
    names = {p: n for n, p in model.named_parameters()}
    return {"state": {k: v.detach().clone().numpy() for k, v in model.state_dict().items()},
            "ctrl": {k: v.clone().numpy() for k, v in trainer.ctrl.as_dict().items()},
            "momentum": {names[p]: s["momentum_buffer"].clone().numpy()
                         for p, s in trainer.optimizer.state.items() if "momentum_buffer" in s}}


def _load_start(model, trainer, start):
    model.load_state_dict({k: torch.as_tensor(v) for k, v in start["state"].items()}, strict=False)
    if start.get("ctrl") is not None:
        trainer.ctrl = ControllerState(**{k: torch.as_tensor(v) for k, v in start["ctrl"].items()})
    for name, p in model.named_parameters():
        if name in start.get("momentum", {}):
            buf = torch.empty_like(p)  # the parameter's memory format, as SGD makes its buffers
            buf.copy_(torch.as_tensor(start["momentum"][name]))
            trainer.optimizer.state[p]["momentum_buffer"] = buf


def _run_steps(family, starts, batches, flips, momentum, world):
    """Guided steps of a trainer on the rows of ``batches`` and ``flips``
    the world gives this rank (all of them without a world).  Step t starts
    from ``starts[t]`` (:func:`_start`) where that is given, else from the
    previous step's end: f32 rounding of one step grows ~1000-fold in the
    next at lr 0.1 on these maps, so each step is compared from one state."""
    model = _model(family)
    trainer = _trainer(model, momentum, world)
    outs, begun, states, collectives = [], [], [], []
    for start, batch, flip in zip(starts, batches, flips):
        if start is not None:
            _load_start(model, trainer, start)
        begun.append(_start(model, trainer))
        rows = world.rows(len(batch["mask"])) if world is not None else slice(None)
        parallel.reset_collective_count()
        out = trainer.train_batch({k: torch.from_numpy(v[rows]) for k, v in batch.items()},
                                  torch.from_numpy(flip[rows]), torch.tensor(True))
        collectives.append(parallel.collective_count())
        outs.append({k: out[k].numpy().copy() for k in ("loss", "acc", "acc_modal", "curated")})
        states.append({k: v.detach().clone().numpy() for k, v in model.state_dict().items()})
    return {"outs": outs, "starts": begun, "states": states, "collectives": collectives,
            "ctrl": {k: v.numpy() for k, v in trainer.ctrl.as_dict().items()}}


def _seeded_state(family, seed=0):
    model = _model(family)
    init_parameters(model, prng.PRNGKey(seed))
    return {k: v.numpy().copy() for k, v in model.state_dict().items()}


def _batches(shape, masks, seed=0):
    rng = np.random.default_rng(seed)
    return [{
        "images": rng.integers(0, 256, shape, dtype=np.uint8),
        "labels": rng.integers(0, NC, shape[0]).astype(np.int32),
        "mask": np.asarray(mask, np.float32),
    } for mask in masks]


def _flips(shape, n, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.random(shape) < 0.5 for _ in range(n)]


def _check_update(got, want, before, tol, where):
    for key, w in want.items():
        g = got[key]
        if not np.issubdtype(w.dtype, np.floating):
            continue
        err = float(np.linalg.norm(g - w))
        upd = float(np.linalg.norm(w - before[key]))
        assert err <= tol * upd + 1e-7, (where, key, err, upd)


def _compare_ranks_to_one(ranks, one, param_names):
    """Every rank's state, outputs and controller are the other's, bit for
    bit; each step's against the one-process step from the same start."""
    for other in ranks[1:]:
        for a, b in zip(ranks[0]["states"] + ranks[0]["outs"] + [ranks[0]["ctrl"]],
                        other["states"] + other["outs"] + [other["ctrl"]]):
            for key in a:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    got = ranks[0]
    for t, (g, w) in enumerate(zip(got["outs"], one["outs"])):
        for key in ("loss", "acc", "acc_modal"):
            np.testing.assert_allclose(g[key], w[key], *RANKS_TOL, err_msg=f"step {t} {key}")
        np.testing.assert_array_equal(g["curated"], w["curated"])
    for key in FIELDS:
        if key in ("M_main", "M_bypass", "d_BDR"):
            np.testing.assert_allclose(got["ctrl"][key], one["ctrl"][key], rtol=1e-4, err_msg=key)
        else:
            np.testing.assert_array_equal(got["ctrl"][key], one["ctrl"][key], err_msg=key)
    for t, (g, w, start) in enumerate(zip(got["states"], one["states"], one["starts"])):
        _check_update({k: g[k] for k in param_names}, {k: w[k] for k in param_names}, start["state"], UPDATE_TOL, t)
        for key in w:
            if key not in param_names and np.issubdtype(w[key].dtype, np.floating):
                # BatchNorm statistics, MMTM running averages and step
                np.testing.assert_allclose(g[key], w[key], *RANKS_TOL, err_msg=f"step {t} {key}")
    assert all(c > 0 for c in got["collectives"]) and got["collectives"] == ranks[-1]["collectives"]


def _jax_start(state):
    """The port's start (:func:`_start`) from a JAX train state: its
    parameters, BatchNorm statistics and MMTM buffers, its controller and
    its momentum trace."""
    import jax
    import optax

    from greedy_multimodal_learning_tpu_torch.engine import state_dict_from_jax

    state = jax.device_get(state)
    traces = [s for s in jax.tree_util.tree_leaves(state.opt_state, is_leaf=lambda x: isinstance(x, optax.TraceState))
              if isinstance(s, optax.TraceState)]
    return {
        "state": {k: v.numpy() for k, v in state_dict_from_jax(state.params, state.batch_stats, state.mmtm).items()},
        "ctrl": {f: np.asarray(getattr(state.controller, f)) for f in FIELDS},
        "momentum": {k: v.numpy() for k, v in state_dict_from_jax(traces[0].trace, {}).items()} if traces else {},
    }


def _jax_reference(momentum, devices=2, model_parallel=1):
    """Two guided steps of the JAX package's sharded step on a mesh of
    ``devices`` CPU devices, ``model_parallel`` a model axis
    (``tests/test_parallel.py:18-86``): the port's start before each step,
    the flips, the losses and the parameters after the first."""
    import jax
    import jax.numpy as jnp

    from greedy_multimodal_learning_tpu.engine import build_train_step, create_train_state
    from greedy_multimodal_learning_tpu.engine import make_optimizer as jax_make_optimizer
    from greedy_multimodal_learning_tpu.engine.bdr import build_group_matrix
    from greedy_multimodal_learning_tpu.engine.steps import make_controller_update
    from greedy_multimodal_learning_tpu.models import MMTMMVCNN as JaxMMTMMVCNN
    from greedy_multimodal_learning_tpu.parallel import make_mesh, shard_batch, shard_train_state
    from greedy_multimodal_learning_tpu_torch.engine import state_dict_from_jax

    model = JaxMMTMMVCNN(nclasses=NC, num_towers=2)
    optimizer = jax_make_optimizer(lr=LR, momentum=momentum)
    state = create_train_state(model, optimizer, jax.random.PRNGKey(0), jnp.zeros((B, V, IMG, IMG, 3), jnp.float32))
    gm = build_group_matrix(state.params, ["net_view_0", "net_view_1"], ["visual", "skeleton"])
    ctrl = make_controller_update("guided", 2, epsilon=EPSILON, curation_windowsize=WINDOW)
    step = build_train_step(model, optimizer, gm, ctrl, donate=False)
    batches = _batches((B, V, IMG, IMG, 3), [np.ones(B)] * 2)

    mesh = make_mesh(jax.devices()[:devices], model_parallel=model_parallel)
    sh = shard_train_state(state, mesh)
    ref = {"starts": [], "flips": [], "losses": [], "batches": batches}
    with mesh:
        for b in batches:
            ref["starts"].append(_jax_start(sh))
            ref["flips"].append(np.asarray(jax.random.bernoulli(jax.random.fold_in(sh.rng, sh.step), 0.5, (B, V))))
            sh, out = step(sh, shard_batch({**b, "indices": np.arange(B, dtype=np.int32)}, mesh), jnp.asarray(True))
            ref["losses"].append(float(out["loss"]))
            if "params_1" not in ref:
                ref["params_1"] = {k: v.numpy() for k, v in state_dict_from_jax(jax.device_get(sh.params), {}).items()}
    return ref


def _bn(dims, seed=0):
    bn = (BatchNorm2d if dims == 4 else BatchNorm3d)(6)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        bn.weight.copy_(0.5 + torch.rand(6, generator=g))
        bn.bias.copy_(0.1 * torch.randn(6, generator=g))
    return bn


def _bn_pass(dims, x, upstream, mask):
    """The masked train BatchNorm on ``x`` with the upstream gradient
    ``upstream``: output, gradients and running statistics."""
    bn = _bn(dims)
    x = torch.from_numpy(x).requires_grad_(True)
    y = bn(x, True, torch.from_numpy(mask))
    (y * torch.from_numpy(upstream)).sum().backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(), "dw": bn.weight.grad.numpy(), "db": bn.bias.grad.numpy(),
            "mean": bn.running_mean.numpy().copy(), "var": bn.running_var.numpy().copy()}


def _bn_inputs(dims):
    rng = np.random.default_rng(dims)
    shape = (8, 6, 5, 5) if dims == 4 else (8, 6, 3, 4, 4)
    return (rng.normal(1.0, 2.0, shape).astype(np.float32), rng.normal(size=shape).astype(np.float32),
            np.array([1, 1, 1, 1, 1, 0, 0, 0], np.float32))


def _rank_cases(rank, steps, bn):
    """Every spawned case on this rank: ``steps`` {name: _run_steps
    arguments}, ``bn`` {dims: (x, upstream, mask)} of the joined batch."""
    world = _join_gloo()
    try:
        out = {name: _run_steps(*args, world) for name, args in steps.items()}
        for dims, (x, upstream, mask) in bn.items():
            rows = world.rows(len(mask))
            with parallel.data_parallel(world):
                out[f"bn{dims}"] = _bn_pass(dims, x[rows], upstream[rows], mask[rows])
        return out
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def spawned():
    """The references (the JAX mesh at momentum 0 and 0.9, the one-process
    port) and every case on two spawned ranks, in one spawn."""
    refs, steps = {}, {}
    for m in (0.0, 0.9):
        refs[f"jax{m}"] = ref = _jax_reference(m)
        steps[f"jax{m}"] = ("2d", ref["starts"], ref["batches"], ref["flips"], m)
    # two guided steps curating modality 1 (the curated forward reads the
    # world's running averages); in the second batch the second rank's four
    # rows are padding only, and its share of every mean is 0 over the
    # world's count
    batches = _batches((B, V, IMG, IMG, 3), [np.ones(B), [1, 1, 1, 0, 0, 0, 0, 0]])
    flips = _flips((B, V), len(batches))
    ctrl = {"M_main": np.zeros(2, np.float32), "M_bypass": np.zeros(2, np.float32), "curation_mode": np.array(True),
            "caring_modality": np.array(1, np.int32), "curation_step": np.array(0, np.int32),
            "d_BDR": np.array(0, np.float32)}
    for m in (0.0, 0.9):
        refs[f"2d{m}"] = one = _run_steps("2d", [{"state": _seeded_state("2d"), "ctrl": ctrl}, None], batches, flips,
                                          m, None)
        steps[f"2d{m}"] = ("2d", one["starts"], batches, flips, m)
    # the remat model at two ranks against the one process without remat
    steps["2d_remat"] = ("2d_remat",) + steps["2d0.0"][1:]
    clips, clip_flips = _batches((4, 3, 4, 32, 32, 3), [[1, 1, 1, 0]], seed=3), _flips((4,), 1)  # 4 frames of 32²
    refs["3d"] = one = _run_steps("3d", [{"state": _seeded_state("3d")}], clips, clip_flips, 0.0, None)
    steps["3d"] = ("3d", one["starts"], clips, clip_flips, 0.0)
    bn = {dims: _bn_inputs(dims) for dims in (4, 5)}
    for dims, args in bn.items():
        refs[f"bn{dims}"] = _bn_pass(dims, *args)
    return refs, run_ranks(_rank_cases, 2, steps, bn, timeout=RUN_TIMEOUT)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_two_ranks_match_the_jax_two_device_mesh(spawned, momentum):
    """Two guided steps of two port ranks, each from the JAX state before it
    (the second with JAX's momentum trace), against the JAX mesh's."""
    refs, ranks = spawned
    ref = refs[f"jax{momentum}"]
    for r in ranks:
        got = r[f"jax{momentum}"]
        np.testing.assert_allclose([float(o["loss"]) for o in got["outs"]], ref["losses"], rtol=JAX_LOSS_RTOL)
        for key, want in ref["params_1"].items():
            np.testing.assert_allclose(got["states"][0][key], want, *JAX_PARAM_TOL, err_msg=key)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_two_ranks_match_one_process(spawned, momentum):
    refs, ranks = spawned
    one = refs[f"2d{momentum}"]
    _compare_ranks_to_one([r[f"2d{momentum}"] for r in ranks], one, [n for n, _ in _model("2d").named_parameters()])
    assert [bool(o["curated"]) for o in one["outs"]] == [True, True]


def test_remat_at_two_ranks_matches_one_process_without(spawned):
    refs, ranks = spawned
    _compare_ranks_to_one([r["2d_remat"] for r in ranks], refs["2d0.0"],
                          [n for n, _ in _model("2d").named_parameters()])
    # the recompute issues the two forward sums of each block's BatchNorms
    # again: 19 a tower (the stem's is not in a block)
    assert ranks[0]["2d_remat"]["collectives"][0] == ranks[0]["2d0.0"]["collectives"][0] + 2 * 2 * 19


def test_3d_family_two_ranks_match_one_process(spawned):
    refs, ranks = spawned
    _compare_ranks_to_one([r["3d"] for r in ranks], refs["3d"], [n for n, _ in _model("3d").named_parameters()])


@pytest.mark.parametrize("dims", [4, 5])
def test_world_reduced_batchnorm_matches_the_joined_batch(spawned, dims):
    refs, ranks = spawned
    one, ranks = refs[f"bn{dims}"], [r[f"bn{dims}"] for r in ranks]
    np.testing.assert_allclose(np.concatenate([r["y"] for r in ranks]), one["y"], *RANKS_TOL)
    np.testing.assert_allclose(np.concatenate([r["dx"] for r in ranks]), one["dx"], *RANKS_TOL)
    # each rank holds its rows' share of the weight gradients; the world's
    # gradient is their sum (the step all-reduces it)
    for key in ("dw", "db"):
        np.testing.assert_allclose(sum(r[key] for r in ranks), one[key], *RANKS_TOL, err_msg=key)
    for key in ("mean", "var"):
        for r in ranks:
            np.testing.assert_allclose(r[key], one[key], *RANKS_TOL, err_msg=key)


@pytest.mark.parametrize("family", ["2d", "3d", "2d_remat"])
def test_world_one_is_the_plain_step_bit_for_bit(family):
    """A one-rank group of this process: every collective runs, and the
    state, outputs and controller after two steps (the second padded) equal
    the plain step's exactly."""
    shape = (4, 3, 4, 32, 32, 3) if family == "3d" else (B, V, IMG, IMG, 3)
    state0 = _seeded_state(family)
    masks = [np.ones(shape[0]), np.r_[np.ones(shape[0] - 3), np.zeros(3)]]
    batches = _batches(shape, masks)
    flips = _flips(shape[:1] if family == "3d" else shape[:2], 2)
    starts = [{"state": state0}, None]
    plain = _run_steps(family, starts, batches, flips, 0.9, None)
    world, made = parallel.join_world("cpu")
    try:
        one_rank = _run_steps(family, starts, batches, flips, 0.9, world)
    finally:
        parallel.leave_world(made)
    assert made and all(c > 0 for c in one_rank["collectives"])
    for g, w in zip(one_rank["states"] + one_rank["outs"] + [one_rank["ctrl"]],
                    plain["states"] + plain["outs"] + [plain["ctrl"]]):
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_flips_of_two_ranks_join_into_the_one_process_draw():
    import jax

    model = MMTMMVCNN(nclasses=NC)
    one = _trainer(model, 0.0, None)
    ranks = [_trainer(model, 0.0, parallel.World(size=2, rank=r, local_size=2)) for r in range(2)]
    for step in (0, 5):
        for t in [one] + ranks:
            t.step = step
        joined = torch.cat([t.train_flips(B // 2, V) for t in ranks])
        assert torch.equal(joined, one.train_flips(B, V))
        assert torch.equal(torch.cat([t.train_flips(2) for t in ranks]), one.train_flips(4))
        # the JAX package's draw of the global batch (steps.py:88)
        key = jax.random.fold_in(jax.random.split(jax.random.PRNGKey(777))[1], step)
        np.testing.assert_array_equal(joined.numpy(), np.asarray(jax.random.bernoulli(key, 0.5, (B, V))))


def test_a_batch_the_ranks_do_not_split_raises():
    world = parallel.World(size=2, rank=1, local_size=2)
    assert world.rows(8) == slice(4, 8)
    with pytest.raises(ValueError, match="multiple of the ranks a node"):
        world.rows(7)
    nodes = parallel.World(size=4, rank=3, local_size=2)  # two nodes of two ranks
    assert (nodes.node, nodes.n_nodes, nodes.local_rank, nodes.rows(6)) == (1, 2, 1, slice(3, 6))


def test_rank_rows_of_streamed_and_cached_batches(tmp_path):
    """Each rank's rows of every batch, streamed and gathered from the
    device corpus alike: the node batch's rows of images, labels and mask
    (a block of padding only included), the node batch's indices and size."""
    from greedy_multimodal_learning_tpu_torch.data import MultiviewModelNet
    from greedy_multimodal_learning_tpu_torch.data.pipeline import BatchPipeline, adopt_world, wrap_device_cache
    from greedy_multimodal_learning_tpu_torch.data.synthetic import make_synthetic_modelnet

    root = make_synthetic_modelnet(str(tmp_path / "data"), n_train=10, n_test=2, num_views=2, image_size=16,
                                   nclasses=NC)
    ds = MultiviewModelNet(root, "train", specific_view=[0, 1])
    whole = list(BatchPipeline(ds, range(10), 8, prefetch=0))
    for rank in range(2):
        pipes = [BatchPipeline(ds, range(10), 8, prefetch=0)]
        pipes.append(wrap_device_cache(pipes[0], True, "cpu"))
        adopt_world(pipes, parallel.World(size=2, rank=rank, local_size=2))
        for pipe in pipes:
            batches = list(pipe)
            assert len(batches) == 2
            for got, want in zip(batches, whole):
                rows = slice(4 * rank, 4 * rank + 4)
                assert got["rows"] == rows and got["size"] == want["size"]
                np.testing.assert_array_equal(got["indices"], want["indices"])
                for key in ("images", "labels", "mask"):
                    np.testing.assert_array_equal(np.asarray(got[key]), want[key][rows], err_msg=key)
        assert not np.asarray(batches[1]["mask"]).any() if rank else np.asarray(batches[1]["mask"]).sum() == 2
    with pytest.raises(ValueError, match="multiple of the ranks a node"):
        adopt_world([BatchPipeline(ds, range(10), 7)], parallel.World(size=2, rank=0, local_size=2))
