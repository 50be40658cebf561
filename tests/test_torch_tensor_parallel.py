"""Tensor parallelism of the port (``greedy_multimodal_learning_tpu_torch/parallel/tensor.py``)
on the CPU, with the harness of ``tests/test_torch_parallel.py``: ranks are
spawned processes in a gloo group (one thread each, a 60 s group timeout, a
deadline on every run), one spawn a world size.  The model is the JAX
test's (``tests/test_parallel.py``): full channels, 32², B=8, 4 classes.

* world 2 (tp 2) and world 4 (dp 2 × tp 2) against the JAX package's
  dp 4 × tp 2 sharded step (``make_mesh(jax.devices()[:8],
  model_parallel=2)``, ``shard_train_state``) on the same weights, batches
  and flips, momentum 0 and 0.9: the losses of two steps within rtol 1e-4
  and the parameters after one within rtol 2e-2, atol 2e-4, JAX's own
  tolerances;
* the same worlds against the port's one process, each step from the same
  start (the second with padding rows): every parameter's update within
  1e-3 in L2, the BatchNorm statistics, MMTM buffers, outputs and the
  controller as in ``tests/test_torch_parallel.py``, every rank's whole
  state equal to the others' bit for bit although each model rank's
  gradients are scaled apart by 1 + 1e-6·(model index) before they are
  reduced, as a backward that rounds differently on each card would leave
  them, and the BDR sums of the gradients
  and the weights equal to one process's; the eager and the kernel gating
  paths (the plain kernel version here), remat and tp 4 at world 4;
* each rank holds 26 weights of O/tp rows, its momentum buffers alike, and
  every other tensor whole;
* the 3-D family at width 0.25 with ``model_parallel_min_dim=64``, with
  5-D weights sharded, against one process;
* a world or a node that model_parallel does not divide raises; the rows
  and flips of a grid's ranks.

The two spawns (worlds 2 and 4) run at the same time.
"""

import concurrent.futures
import contextlib
import datetime
import hashlib
import os
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

from greedy_multimodal_learning_tpu_torch import parallel
from greedy_multimodal_learning_tpu_torch.engine import Trainer, make_optimizer
from greedy_multimodal_learning_tpu_torch.engine import steps as steps_module
from greedy_multimodal_learning_tpu_torch.models import MMTM3DCNN, MMTMMVCNN
from greedy_multimodal_learning_tpu_torch.parallel import tensor as tensor_parallel
from greedy_multimodal_learning_tpu_torch.parallel.launch import run_ranks
from test_torch_parallel import (
    B,
    EPSILON,
    IMG,
    JAX_LOSS_RTOL,
    JAX_PARAM_TOL,
    LR,
    NC,
    RANKS_TOL,
    UPDATE_TOL,
    V,
    WINDOW,
    _batches,
    _flips,
    _jax_reference,
    _load_start,
    _seeded_state,
)

GROUP_TIMEOUT = datetime.timedelta(seconds=60)
RUN_TIMEOUT = 240.0  # seconds for every rank of a spawned run
SHARDED_2D = 26  # per tower layer3's and layer4's 5 convolutions, 3 linears at mmtm3 and at mmtm4
# The recompute issues each block's two BatchNorm sums again (19 BatchNorms
# a tower in blocks) and the joins of its sharded convolutions (10 a tower).
REMAT_EXTRA = 2 * (2 * 19 + 10)
# A sum of squares of the gradient: the gradient agrees within UPDATE_TOL in
# L2 (the batch's sums split over the data indices), its square within twice.
BDR_GRAD_RTOL = 2 * UPDATE_TOL
FLOAT_FIELDS = ("M_main", "M_bypass", "d_BDR")
EXACT_FIELDS = ("curation_mode", "caring_modality", "curation_step")
# Each model rank's gradients are scaled by 1 + ROUND_APART·(model index) as
# they are computed, as a backward whose sums run in another order on each
# card would round them apart: the replicated copies of a model group must
# end the step equal all the same.
ROUND_APART = 1e-6


def _model(family):
    """``2d``, ``2d_pallas`` (the gating kernel's path: its plain version on
    the CPU), ``2d_remat`` or ``3d`` (width 0.25)."""
    if family == "3d":
        return MMTM3DCNN(nclasses=NC, width_multiplier=0.25).to(memory_format=torch.channels_last_3d)
    return MMTMMVCNN(nclasses=NC, use_pallas=family == "2d_pallas", remat=family == "2d_remat").to(
        memory_format=torch.channels_last)


def _snapshot(model, trainer):
    """A step's start, whole, as tensors: the model's state, the controller
    and SGD's momentum buffers by parameter name."""
    names = {p: n for n, p in model.named_parameters()}
    return {"state": {k: v.detach().clone() for k, v in model.state_dict().items()},
            "ctrl": {k: v.clone() for k, v in trainer.ctrl.as_dict().items()},
            "momentum": {names[p]: s["momentum_buffer"].clone() for p, s in trainer.optimizer.state.items()
                         if "momentum_buffer" in s}}


def _excess(got, want, rtol, atol) -> float:
    """The largest ``|got - want| - (atol + rtol |want|)``: <= 0 where
    ``np.testing.assert_allclose`` passes."""
    return float(((got - want).abs() - (atol + rtol * want.abs())).max())


def _digest(state) -> str:
    h = hashlib.sha256()
    for k, v in state.items():
        h.update(k.encode())
        h.update(v.contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def _recording_bdr(sums):
    """Appends the BDR sums of the gradients and of the (pre-update) weights
    that each train step inside the block hands its controller."""
    original = steps_module._bdr_sums

    def spy(*args):
        out = original(*args)
        sums.append([v.numpy().copy() for v in out])
        return out

    steps_module._bdr_sums = spy
    try:
        yield sums
    finally:
        steps_module._bdr_sums = original


def _run_steps(family, starts, batches, flips, momentum, world, ref=None):
    """Guided steps of a trainer on the rows of ``batches`` and ``flips``
    that ``world`` gives this rank (all of them without a world), the
    rank's weights split over its model group (``model_parallel_min_dim``
    64 for the 3-D family's width-0.25 trunks, as
    ``test_sharded_3d_step_matches_single_device``).  Step t starts from
    ``starts[t]`` (:func:`_snapshot`, loaded whole) where that is given,
    else from the previous step's end, as in ``tests/test_torch_parallel.py``.

    Without ``ref`` (one process) each step's start and end state are kept
    whole.  With ``ref`` (a rank) only what the tests compare: against
    ``ref["ends"]`` the L2 of each parameter's difference and of the
    update, and each other tensor's excess over ``RANKS_TOL``; against
    ``ref["params_1"]`` (JAX's first step) each parameter's excess over
    JAX's tolerance; a digest of the whole state."""
    model = _model(family)
    trainer = Trainer(model, make_optimizer(model.parameters(), lr=LR, momentum=momentum),
                      nummodalities=model.num_towers, controller_kind="guided",
                      controller_config={"epsilon": EPSILON, "curation_windowsize": WINDOW}, device="cpu",
                      world=world, model_parallel_min_dim=64 if family == "3d" else 256)
    trainer.distribute()
    if world is not None:
        scale = 1 + ROUND_APART * world.model_index
        for p in model.parameters():
            p.register_hook(lambda g: g * scale)
    param_names = {n for n, _ in model.named_parameters()}
    out = {"outs": [], "collectives": [], "bdr": [], "starts": [], "ends": [], "update": [], "buffers": [],
           "jax_excess": [], "digests": []}
    for t, (start, batch, flip) in enumerate(zip(starts, batches, flips)):
        with tensor_parallel.unsharded(model, trainer.optimizer):
            if start is not None:
                _load_start(model, trainer, start)
            if ref is None:
                out["starts"].append(_snapshot(model, trainer))
        rows = world.rows(len(batch["mask"])) if world is not None else slice(None)
        parallel.reset_collective_count()
        with _recording_bdr(out["bdr"]):
            step = trainer.train_batch({k: torch.from_numpy(v[rows]) for k, v in batch.items()},
                                       torch.from_numpy(flip[rows]), torch.tensor(True))
        out["collectives"].append(parallel.collective_count())
        out["outs"].append({k: step[k].numpy().copy() for k in ("loss", "acc", "acc_modal", "curated")})
        with tensor_parallel.unsharded(model, trainer.optimizer):
            state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        if ref is None:
            out["ends"].append(state)
            continue
        out["digests"].append(_digest(state))
        if "ends" in ref:
            want, before = ref["ends"][t], starts[t]["state"]
            out["update"].append({k: (float((state[k] - want[k]).norm()), float((want[k] - before[k]).norm()))
                                  for k in param_names})
            out["buffers"].append({k: _excess(state[k], want[k], *RANKS_TOL) for k in want
                                   if k not in param_names and want[k].is_floating_point()})
        if t == 0 and "params_1" in ref:
            out["jax_excess"] = {k: _excess(state[k], v, *JAX_PARAM_TOL) for k, v in ref["params_1"].items()}
    names = {p: n for n, p in model.named_parameters()}
    out.update(ctrl={k: v.numpy() for k, v in trainer.ctrl.as_dict().items()},
               held={k: tuple(v.shape) for k, v in model.state_dict().items()},
               momentum_held={names[p]: tuple(s["momentum_buffer"].shape) for p, s in trainer.optimizer.state.items()
                              if "momentum_buffer" in s})
    return out


def _rank_cases(rank, refs_path, worlds):
    """Every spawned case on this rank: ``worlds`` [(model_parallel,
    {name: (family, reference name, steps, momentum, batches, flips)})], one
    world of the group after another; the references' starts, ends and
    JAX parameters memory-mapped from ``refs_path``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://", timeout=GROUP_TIMEOUT)
    try:
        refs = torch.load(refs_path, mmap=True, weights_only=True)
        out = {}
        for tp, cases in worlds:
            world = parallel.world_from_process_group(tp)
            for name, (family, ref_name, steps, momentum, batches, flips) in cases.items():
                ref = {k: v[:steps] if k != "params_1" else v for k, v in refs[ref_name].items()}
                out[name] = _run_steps(family, ref["starts"], batches[:steps], flips[:steps], momentum, world, ref)
        return out
    finally:
        dist.destroy_process_group()


def _ctrl_curating():
    return {"M_main": torch.zeros(2), "M_bypass": torch.zeros(2), "curation_mode": torch.tensor(True),
            "caring_modality": torch.tensor(1, dtype=torch.int32), "curation_step": torch.tensor(0, dtype=torch.int32),
            "d_BDR": torch.tensor(0.0)}


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree, copy=True))


@pytest.fixture(scope="module")
def spawned():
    """The references (the JAX dp 4 × tp 2 mesh at momentum 0 and 0.9, the
    one-process port), written once for the ranks to map, and the cases at
    world 2 (tp 2) and at world 4 (dp 2 × tp 2, then tp 4), one spawn a
    world size."""
    refs, saved, common = {}, {}, {}
    for m in (0.0, 0.9):
        ref = _jax_reference(m, devices=8, model_parallel=2)
        refs[f"jax{m}"] = {"losses": ref["losses"]}
        saved[f"jax{m}"] = {"starts": [_tensors(s) for s in ref["starts"]], "params_1": _tensors(ref["params_1"])}
        common[f"jax{m}"] = ("2d", f"jax{m}", 2, m, ref["batches"], ref["flips"])
    # two guided steps curating modality 1, the second batch's last five rows
    # padding (at world 4 the second data index's rows all padding)
    batches = _batches((B, V, IMG, IMG, 3), [np.ones(B), [1, 1, 1, 0, 0, 0, 0, 0]])
    flips = _flips((B, V), len(batches))
    seeded = {"state": _tensors(_seeded_state("2d")), "ctrl": _ctrl_curating()}
    for family, m in (("2d", 0.0), ("2d_pallas", 0.9)):
        one = _run_steps(family, [seeded, None], batches, flips, m, None)
        saved[f"{family}{m}"] = {"starts": one.pop("starts"), "ends": one.pop("ends")}
        refs[f"{family}{m}"] = one
        common[f"{family}{m}"] = (family, f"{family}{m}", 2, m, batches, flips)
    clips, clip_flips = _batches((4, 3, 4, 32, 32, 3), [[1, 1, 1, 0]], seed=3), _flips((4,), 1)  # 4 frames of 32²
    one = _run_steps("3d", [{"state": _tensors(_seeded_state("3d"))}], clips, clip_flips, 0.0, None)
    saved["3d"] = {"starts": one.pop("starts"), "ends": one.pop("ends")}
    refs["3d"] = one
    two = dict(common, remat=("2d_remat", "2d0.0", 2, 0.0, batches, flips),
               **{"3d": ("3d", "3d", 1, 0.0, clips, clip_flips)})
    tp4 = {"tp4": ("2d", "2d0.0", 1, 0.0, batches, flips)}  # the first step of 2d0.0 at tp 4
    four = {k: v for k, v in common.items() if k != "2d0.0"}  # the eager path at world 4: the JAX cases
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "refs.pt")
        torch.save(saved, path)
        del saved, one
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            runs = {2: pool.submit(run_ranks, _rank_cases, 2, path, [(2, two)], timeout=RUN_TIMEOUT),
                    4: pool.submit(run_ranks, _rank_cases, 4, path, [(2, four), (4, tp4)], timeout=RUN_TIMEOUT)}
            ranks = {n: run.result() for n, run in runs.items()}
    return refs, ranks


def _param_count(family):
    return len(list(_model(family).parameters()))


def _check_against_one(ranks, one, n_params, steps=None):
    """Every rank's whole state equal to the others' (digests), and each
    step against the one process's from the same start, as
    ``tests/test_torch_parallel.py::_compare_ranks_to_one``: outputs and
    the controller, each parameter's update within ``UPDATE_TOL`` in L2,
    every other tensor within ``RANKS_TOL``; collectives issued alike."""
    steps = steps or len(one["outs"])
    assert all(r["digests"] == ranks[0]["digests"] for r in ranks) and len(ranks[0]["digests"]) == steps
    got = ranks[0]
    for t, (g, w) in enumerate(zip(got["outs"], one["outs"][:steps])):
        for key in ("loss", "acc", "acc_modal"):
            np.testing.assert_allclose(g[key], w[key], *RANKS_TOL, err_msg=f"step {t} {key}")
        np.testing.assert_array_equal(g["curated"], w["curated"])
    if steps == len(one["outs"]):
        for key in FLOAT_FIELDS:
            np.testing.assert_allclose(got["ctrl"][key], one["ctrl"][key], rtol=1e-4, err_msg=key)
        for key in EXACT_FIELDS:
            np.testing.assert_array_equal(got["ctrl"][key], one["ctrl"][key], err_msg=key)
    for t in range(steps):
        assert len(got["update"][t]) == n_params
        beyond = {k: (e, u) for k, (e, u) in got["update"][t].items() if e > UPDATE_TOL * u + 1e-7}
        assert not beyond, (t, beyond)
        assert max(got["buffers"][t].values()) <= 0, (t, {k: v for k, v in got["buffers"][t].items() if v > 0})
    assert all(c > 0 for c in got["collectives"]) and all(r["collectives"] == got["collectives"] for r in ranks)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_matches_the_jax_sharded_step(spawned, world, momentum):
    """Two guided steps of every rank, each from the JAX state before it
    (the second with JAX's momentum trace, sharded like its parameters),
    against the JAX dp 4 × tp 2 mesh."""
    refs, ranks = spawned
    for r in ranks[world]:
        got = r[f"jax{momentum}"]
        np.testing.assert_allclose([float(o["loss"]) for o in got["outs"]], refs[f"jax{momentum}"]["losses"],
                                   rtol=JAX_LOSS_RTOL)
        assert len(got["jax_excess"]) == _param_count("2d")
        assert max(got["jax_excess"].values()) <= 0, {k: v for k, v in got["jax_excess"].items() if v > 0}


@pytest.mark.parametrize("world, case", [(2, "2d0.0"), (2, "2d_pallas0.9"), (4, "2d_pallas0.9")])
def test_matches_one_process(spawned, world, case):
    refs, ranks = spawned
    _check_against_one([r[case] for r in ranks[world]], refs[case], _param_count("2d"))
    assert [bool(o["curated"]) for o in refs[case]["outs"]] == [True, True]


@pytest.mark.parametrize("world, case", [(2, "2d0.0"), (2, "2d_pallas0.9"), (4, "2d_pallas0.9")])
def test_bdr_sums_equal_one_process(spawned, world, case):
    """The BDR sums of the gradients and the weights, each whole tensor
    counted once: summing one rank's rows of a sharded tensor, or a
    replicated one tp times, would move the ratios, and the controller's
    decisions with them."""
    refs, ranks = spawned
    for r in ranks[world]:
        for t, (g, w) in enumerate(zip(r[case]["bdr"], refs[case]["bdr"])):
            np.testing.assert_allclose(g[0], w[0], rtol=BDR_GRAD_RTOL, err_msg=f"step {t} gradients")
            np.testing.assert_allclose(g[1], w[1], *RANKS_TOL, err_msg=f"step {t} weights")


@pytest.mark.parametrize("world", [2, 4])
def test_each_rank_holds_its_rows(spawned, world):
    """26 weights of O/tp rows (O 256 or 512), their momentum buffers alike,
    every other tensor whole."""
    refs, ranks = spawned
    whole = refs["2d_pallas0.9"]["held"]
    for r in ranks[world]:
        got = r["2d_pallas0.9"]
        split = {k: s for k, s in got["held"].items() if s != whole[k]}
        assert len(split) == SHARDED_2D, sorted(split)
        for key, shape in split.items():
            assert whole[key][0] in (256, 512) and shape == (whole[key][0] // 2,) + whole[key][1:], key
        assert len(got["momentum_held"]) == _param_count("2d")
        assert got["momentum_held"] == {k: got["held"][k] for k in got["momentum_held"]}


def test_remat_at_tp2_matches_one_process_without(spawned):
    refs, ranks = spawned
    _check_against_one([r["remat"] for r in ranks[2]], refs["2d0.0"], _param_count("2d"))
    for r in ranks[2]:
        assert r["remat"]["collectives"][0] == r["2d0.0"]["collectives"][0] + REMAT_EXTRA


def test_tp4_at_world_4_matches_one_process(spawned):
    """4-way tensor parallelism (the counterpart of ``test_tp4_mesh``): a
    finite step that is the one process's first."""
    refs, ranks = spawned
    got = [r["tp4"] for r in ranks[4]]
    assert np.isfinite(float(got[0]["outs"][0]["loss"]))
    _check_against_one(got, refs["2d0.0"], _param_count("2d"), steps=1)
    whole = refs["2d0.0"]["held"]
    quarter = [k for k, s in got[0]["held"].items() if s != whole[k]]
    assert len(quarter) == SHARDED_2D and all(got[0]["held"][k][0] * 4 == whole[k][0] for k in quarter)


def test_3d_family_at_tp2_matches_one_process(spawned):
    """``model_parallel_min_dim=64`` on the width-0.25 trunks
    (``test_sharded_3d_step_matches_single_device``): 5-D kernels split
    like 4-D ones."""
    refs, ranks = spawned
    _check_against_one([r["3d"] for r in ranks[2]], refs["3d"], _param_count("3d"))
    whole = refs["3d"]["held"]
    split = [k for k, s in ranks[2][0]["3d"]["held"].items() if s != whole[k]]
    assert any(len(whole[k]) == 5 for k in split), split


def test_a_model_size_that_does_not_divide_raises():
    with pytest.raises(ValueError, match="does not divide the 2 ranks"):
        parallel.World(size=2, rank=0, local_size=2, model_size=4)
    with pytest.raises(ValueError, match="must not span nodes"):
        parallel.World(size=4, rank=0, local_size=2, model_size=4)
    with pytest.raises(ValueError, match="does not divide the 1 ranks"):
        parallel.join_world("cpu", 2)  # a one-rank group of its own, destroyed again
    assert not dist.is_initialized()


def test_rows_and_flips_of_a_grid():
    """Rank r of dp 2 × tp 2 has data index r // 2 and model index r % 2:
    the two ranks of a model group take the same rows and flips, and the
    data indices' flips join into the one-process draw, the JAX package's
    ``bernoulli(fold_in(data_key, step))`` of the global batch."""
    import jax

    worlds = [parallel.World(size=4, rank=r, local_size=4, model_size=2) for r in range(4)]
    assert [(w.data_index, w.model_index, w.data_size) for w in worlds] == [(0, 0, 2), (0, 1, 2), (1, 0, 2),
                                                                             (1, 1, 2)]
    assert [w.rows(8) for w in worlds] == [slice(0, 4), slice(0, 4), slice(4, 8), slice(4, 8)]
    with pytest.raises(ValueError, match="multiple of the ranks a node"):
        worlds[0].rows(7)
    nodes = parallel.World(size=8, rank=6, local_size=4, model_size=2)  # two nodes of dp 2 × tp 2
    assert (nodes.node, nodes.data_index, nodes.rows(6)) == (1, 3, slice(3, 6))
    model = MMTMMVCNN(nclasses=NC)
    trainers = [Trainer(model, make_optimizer(model.parameters(), lr=LR), device="cpu", world=w) for w in
                [None] + worlds]
    for step in (0, 3):
        for t in trainers:
            t.step = step
        grid = [t.train_flips(B // 2, V) for t in trainers[1:]]
        assert torch.equal(grid[0], grid[1]) and torch.equal(grid[2], grid[3])
        assert torch.equal(torch.cat([grid[0], grid[2]]), trainers[0].train_flips(B, V))
        key = jax.random.fold_in(jax.random.split(jax.random.PRNGKey(777))[1], step)
        np.testing.assert_array_equal(torch.cat([grid[0], grid[2]]).numpy(),
                                      np.asarray(jax.random.bernoulli(key, 0.5, (B, V))))


def test_the_rule_selects_the_jax_leaves():
    """The JAX rule on the port's output-first layout: the 26 leaves it
    shards in the JAX model, 22,282,240 of 23,773,008 parameters."""
    model = MMTMMVCNN(nclasses=40)
    picked = {n: p.numel() for n, p in model.named_parameters() if tensor_parallel.shardable(p.shape, 2, 256)}
    assert len(picked) == SHARDED_2D and sum(picked.values()) == 22_282_240
    assert sum(p.numel() for p in model.parameters()) == 23_773_008
    assert all(".layer3." in n or ".layer4." in n or n.startswith(("mmtm3.", "mmtm4.")) for n in picked)
    assert not tensor_parallel.shardable((40, 512), 2, 256) and not tensor_parallel.shardable((512,), 2, 256)
    assert not tensor_parallel.shardable((512, 512), 3, 256)  # not divisible: replicated, as shard_params
