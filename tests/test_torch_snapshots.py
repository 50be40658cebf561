"""The port's ``training_loop.orbax_dir``: asynchronous rotating full-state
snapshots over ``torch.distributed.checkpoint``
(``greedy_multimodal_learning_tpu_torch/engine/snapshots.py``), the
counterpart of ``tests/test_orbax_ckpt.py`` for the JAX package's Orbax
snapshots, on the CPU:

* a round trip of the whole training state (parameters, BatchNorm
  statistics, MMTM buffers, SGD's momentum, the controller with its key,
  the step, the data key, the learning rate) into a trainer of another
  seed: every tensor equal;
* ``train`` with ``orbax_dir``: one snapshot an epoch under ``save_path``,
  the newest two kept over four epochs; a resume restores the newest
  snapshot over an older ``.pt`` (``checkpoint_every=2``) and ends
  bit-identical to a straight run;
* a snapshot without ``.metadata`` (an interrupted save) is never the
  latest and goes once a newer one completes; a directory of the JAX
  package's Orbax snapshots raises, naming the ``.jax.pkl``;
* tensor parallelism: two gloo ranks at tp 2 save a snapshot (each rank
  its rows of the split weights and their momentum, under keys that name
  the block), then restore it at tp 2, and one process restores it at
  tp 1: every tensor equal to the ranks' whole state.
"""

import csv
import datetime
import os
import shutil

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

from greedy_multimodal_learning_tpu_torch import config as port_cfg
from greedy_multimodal_learning_tpu_torch import parallel
from greedy_multimodal_learning_tpu_torch.bootstrap import init_model
from greedy_multimodal_learning_tpu_torch.data.synthetic import make_synthetic_modelnet
from greedy_multimodal_learning_tpu_torch.engine import Trainer, make_optimizer
from greedy_multimodal_learning_tpu_torch.engine.snapshots import Snapshots, state_to_tree
from greedy_multimodal_learning_tpu_torch.entries import train
from greedy_multimodal_learning_tpu_torch.models import MMTMMVCNN
from greedy_multimodal_learning_tpu_torch.parallel import tensor as tensor_parallel
from greedy_multimodal_learning_tpu_torch.parallel.launch import run_ranks

REPO = os.path.join(os.path.dirname(__file__), "..")
CONFIG = os.path.join(REPO, "configs", "training_random.gin")
NC = 4
GROUP_TIMEOUT = datetime.timedelta(seconds=60)
RUN_TIMEOUT = 240.0
CLOCK_COLUMNS = ("time", "epoch_begin_time", "train_samples_per_sec")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    """A full-width snapshot is ~90 MB (~180 MB with momentum)."""
    port_cfg.clear_config()
    yield
    port_cfg.clear_config()
    shutil.rmtree(tmp_path, ignore_errors=True)


def _trainer(seed, world=None, momentum=0.9):
    model = init_model(MMTMMVCNN(nclasses=NC), seed, "cpu")
    return Trainer(model, make_optimizer(model.parameters(), lr=0.05, momentum=momentum), controller_kind="random",
                   nummodalities=2, seed=seed, device="cpu", verbose=False, world=world)


def _advance(trainer, seed=0):
    """A state no fresh trainer has: momentum buffers, BatchNorm statistics
    and MMTM buffers off their defaults, 7 controller draws, a learning rate."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in trainer.model.parameters():
            buf = torch.empty_like(p)
            buf.copy_(torch.randn(p.shape, generator=g))
            trainer.optimizer.state[p]["momentum_buffer"] = buf
        for name, b in trainer.model.named_buffers():
            if b.is_floating_point():
                b.add_(torch.rand(b.shape, generator=g))
    ones = torch.ones(4)
    for _ in range(7):
        trainer.ctrl = trainer._controller_update(trainer.ctrl, ones, ones, torch.tensor(True))
        trainer.step += 1
    trainer.ctrl.M_main = torch.tensor([1.5, 2.5])
    trainer.set_lr(0.0125)


def _whole(trainer) -> dict:
    """Every tensor of the training state, whole, as numpy, by the key of a
    one-process snapshot."""
    with tensor_parallel.unsharded(trainer.model, trainer.optimizer):
        tree = state_to_tree(trainer)
        return {k.partition("@rows")[0]: v.detach().clone().numpy() for k, v in tree.items()}


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_round_trip_restores_the_whole_state(tmp_path):
    trainer = _trainer(777)
    _advance(trainer)
    want = _whole(trainer)
    snapshots = Snapshots(str(tmp_path / "snapshots"))
    snapshots.save(7, trainer)
    snapshots.wait()
    assert snapshots.latest_step() == 7 and len(snapshots.blocked_s) == 1
    fresh = _trainer(5)  # another seed: other weights and keys
    assert Snapshots(str(tmp_path / "snapshots")).restore_latest(fresh) == 7
    _assert_same(_whole(fresh), want)
    assert fresh.step == 7 and fresh.get_lr() == 0.0125
    np.testing.assert_array_equal(fresh.data_key, trainer.data_key)
    assert torch.equal(fresh.ctrl.rng, trainer.ctrl.rng) and fresh._skip_next_controller_reset
    # the restored trainer draws on where the saved one would have
    ones = torch.ones(4)
    a = trainer._controller_update(trainer.ctrl, ones, ones, torch.tensor(True))
    b = fresh._controller_update(fresh.ctrl, ones, ones, torch.tensor(True))
    assert torch.equal(a.rng, b.rng) and bool(a.curation_mode) == bool(b.curation_mode)


def test_an_interrupted_snapshot_is_never_the_latest(tmp_path):
    trainer = _trainer(777, momentum=0.0)
    snapshots = Snapshots(str(tmp_path / "s"), max_to_keep=2)
    snapshots.save(1, trainer)
    snapshots.wait()
    os.makedirs(tmp_path / "s" / "2")
    (tmp_path / "s" / "2" / "__0_0.distcp").write_bytes(b"partial")  # no .metadata: cut off mid-save
    assert snapshots.latest_step() == 1
    fresh = _trainer(5, momentum=0.0)
    assert snapshots.restore_latest(fresh) == 1
    snapshots.save(3, trainer)
    snapshots.wait()
    assert sorted(os.listdir(tmp_path / "s")) == ["1", "3"]  # the partial one went once 3 completed
    assert Snapshots(str(tmp_path / "empty")).restore_latest(fresh) is None


def test_a_directory_of_orbax_snapshots_raises(tmp_path):
    os.makedirs(tmp_path / "orbax" / "2" / "default")
    (tmp_path / "orbax" / "2" / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match=r"Orbax.*\.jax\.pkl"):
        Snapshots(str(tmp_path / "orbax")).latest_step()


# ---- through the train entry -------------------------------------------------


def _bindings(root, *extra):
    return [f"get_mvdcndata.root_dir='{root}'", "get_mvdcndata.specific_views=[0, 1]", f"MMTM_MVCNN.nclasses={NC}",
            "train.batch_size=4", "train.momentum=0.9", "train.device='cpu'", "MMTM_mitigate.use_pallas=True", *extra]


def _train(root, save, *extra):
    port_cfg.clear_config()
    port_cfg.parse_config_files_and_bindings([CONFIG], "\n".join(_bindings(root, *extra)))
    return train(str(save))


def _rows(save):
    with open(os.path.join(save, "history.csv")) as f:
        rows = list(csv.reader(f))
    keep = [i for i, c in enumerate(rows[0]) if c not in CLOCK_COLUMNS]
    return [[r[i] for i in keep] for r in rows]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    data = tmp_path_factory.mktemp("data")
    yield make_synthetic_modelnet(str(data), n_train=8, n_test=4, num_views=2, image_size=32, nclasses=NC)
    shutil.rmtree(data, ignore_errors=True)


def test_training_loop_keeps_the_newest_two_snapshots(root, tmp_path):
    """Four epochs with ``orbax_dir='orbax'`` (relative: under save_path)
    and the default ``orbax_max_to_keep=2``: epochs 3 and 4 are kept, the
    newest is the run's final state; a stale snapshot of an earlier run
    there (epoch 9) is gone."""
    save = tmp_path / "run"
    os.makedirs(save / "orbax" / "9")
    (save / "orbax" / "9" / ".metadata").write_bytes(b"stale")
    trainer = _train(root, save, "training_loop.n_epochs=5", "training_loop.orbax_dir='orbax'")
    assert [r[0] for r in _rows(save)[1:]] == ["1", "2", "3", "4"]
    assert sorted(os.listdir(save / "orbax")) == ["3", "4"]
    snapshots = Snapshots(str(save / "orbax"))
    assert snapshots.latest_step() == 4
    fresh = _trainer(5)
    snapshots.restore_latest(fresh)
    _assert_same(_whole(fresh), _whole(trainer))


def test_a_resume_takes_the_newest_snapshot_over_an_older_checkpoint(root, tmp_path):
    """``checkpoint_every=2``: after three epochs the ``.pt`` holds epoch 2,
    the snapshots epoch 3.  The resume continues from epoch 3's snapshot
    (epoch 3 is not trained again) and ends as a straight four-epoch run
    does, bit for bit."""
    straight = _train(root, tmp_path / "straight", "training_loop.n_epochs=5", "training_loop.checkpoint_every=2")
    _train(root, tmp_path / "resumed", "training_loop.n_epochs=4", "training_loop.checkpoint_every=2",
           "training_loop.orbax_dir='orbax'")
    first = _rows(tmp_path / "resumed")
    resumed = _train(root, tmp_path / "resumed", "training_loop.n_epochs=5", "training_loop.checkpoint_every=2",
                     "training_loop.orbax_dir='orbax'", "training_loop.resume=True")
    rows = _rows(tmp_path / "resumed")
    assert rows[:4] == first  # epochs 1-3 as the first run wrote them
    assert rows == _rows(tmp_path / "straight")
    assert resumed.step == straight.step
    _assert_same(_whole(resumed), _whole(straight))
    assert sorted(os.listdir(tmp_path / "resumed" / "orbax")) == ["3", "4"]


# ---- tensor parallelism --------------------------------------------------------


def _tp_rank(rank, directory):
    """At tp 2: shard, save a snapshot, then restore it into a trainer of
    another seed; returns the whole state saved and the whole state
    restored, and the snapshot's keys."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://", timeout=GROUP_TIMEOUT)
    try:
        world = parallel.world_from_process_group(model_parallel=2)
        trainer = _trainer(777, world)
        _advance(trainer)
        trainer._take_shards()
        assert tensor_parallel.is_sharded(trainer.model)
        saved = _whole(trainer)
        snapshots = Snapshots(directory, world=world)
        snapshots.save(2, trainer)
        snapshots.close()
        fresh = _trainer(5, world)
        fresh._take_shards()
        restored = Snapshots(directory, world=world)
        assert restored.restore_latest(fresh) == 2
        restored.close()
        rows = {n: tuple(p.shape) for n, p in fresh.model.named_parameters()}
        return saved, _whole(fresh), rows
    finally:
        dist.destroy_process_group()


def test_tp2_snapshot_restores_at_tp2_and_tp1(tmp_path):
    directory = str(tmp_path / "tp")
    (saved0, restored0, rows0), (saved1, restored1, rows1) = run_ranks(_tp_rank, 2, directory,
                                                                       timeout=RUN_TIMEOUT)
    _assert_same(saved1, saved0)  # the model group's whole state is one
    _assert_same(restored0, saved0)
    _assert_same(restored1, saved0)
    assert rows0 == rows1 and rows0["net_view_0.layer4.0.conv1.weight"] == (256, 256, 3, 3)
    # each rank's rows of a split weight went under a key of its own
    keys = set(dcp.FileSystemReader(os.path.join(directory, "2")).read_metadata().state_dict_metadata)
    for block in ("0:256", "256:512"):
        assert f"model/net_view_0.layer4.0.conv1.weight@rows{block}/512" in keys
        assert f"momentum/net_view_0.layer4.0.conv1.weight@rows{block}/512" in keys
    assert sum("@rows" in k for k in keys) == 2 * 2 * 26  # 26 weights and their momentum, two blocks each
    one = _trainer(5)
    assert Snapshots(directory).restore_latest(one) == 2
    _assert_same(_whole(one), saved0)
