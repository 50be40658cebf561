"""Processes and nodes of the port's data parallelism
(``greedy_multimodal_learning_tpu_torch/parallel/multihost.py``) on the CPU,
the counterpart of ``tests/test_multihost.py``:

* ``process_local_indices`` against the JAX package's, with
  ``jax.process_count`` / ``jax.process_index`` patched, over lengths and
  node counts that do and do not divide;
* two simulated nodes of one rank each (spawned, gloo, a 60 s group
  timeout): each node's loaders read its share of every split, and one
  train epoch through ``Trainer.train_loop`` runs on the global batch that
  joins the nodes' batches in node order: the gathered ``train_indices``,
  and the loss and accuracy of the one-process trainer on those joined
  batches within ``LOSS_TOL``;
* ``maybe_initialize_distributed``: no environment gives False,
  ``GML_COORDINATOR_ADDRESS`` raises, ``torchrun``'s environment makes the
  group (and a second call leaves it alone), and a rank's bare ``'cuda'``
  is ``cuda:<LOCAL_RANK>``.
"""

import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist

from greedy_multimodal_learning_tpu_torch import parallel
from greedy_multimodal_learning_tpu_torch.data import get_mvdcndata
from greedy_multimodal_learning_tpu_torch.data.pipeline import BatchPipeline, adopt_world
from greedy_multimodal_learning_tpu_torch.data.synthetic import make_synthetic_modelnet
from greedy_multimodal_learning_tpu_torch.engine import Trainer, make_optimizer
from greedy_multimodal_learning_tpu_torch.engine.callbacks import LambdaCallback
from greedy_multimodal_learning_tpu_torch.models import MMTMMVCNN, init_parameters
from greedy_multimodal_learning_tpu_torch.utils import prng
from greedy_multimodal_learning_tpu_torch.parallel.launch import run_ranks

GROUP_TIMEOUT = datetime.timedelta(seconds=60)
RUN_TIMEOUT = 120.0
IMG, NC, BATCH, LR = 32, 4, 4, 1e-3
LOSS_TOL = (1e-4, 1e-6)  # (rtol, atol): the nodes' sums joined in another order


@pytest.mark.parametrize("length", [0, 1, 5, 7, 8, 13])
@pytest.mark.parametrize("n_nodes", [1, 2, 3, 4])
def test_process_local_indices_match_jax(monkeypatch, length, n_nodes):
    import jax

    from greedy_multimodal_learning_tpu.parallel.multihost import process_local_indices as jax_local

    indices = list(range(100, 100 + length))
    monkeypatch.setattr(jax, "process_count", lambda: n_nodes)
    for node in range(n_nodes):
        monkeypatch.setattr(jax, "process_index", lambda node=node: node)
        assert parallel.process_local_indices(indices, node, n_nodes) == jax_local(indices), (node, n_nodes)


def _trainer(world):
    model = MMTMMVCNN(nclasses=NC).to(memory_format=torch.channels_last)
    init_parameters(model, prng.PRNGKey(0))
    return Trainer(model, make_optimizer(model.parameters(), lr=LR), controller_kind="guided",
                   controller_config={"epsilon": 0.01, "curation_windowsize": 5}, device="cpu", world=world,
                   verbose=False)


def _epoch(trainer, train, valid=None):
    logs = {}
    trainer.train_loop(train, valid_generator=valid, epochs=1, steps_per_epoch=len(train),
                       validation_steps=len(valid) if valid is not None else None,
                       callbacks=[LambdaCallback(on_epoch_end=lambda epoch, l: logs.update(l))])
    return logs


def _rank_node(rank, root):
    """One node of one rank: its loaders, then one train epoch on the
    global batch."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://", timeout=GROUP_TIMEOUT)
    try:
        world = parallel.world_from_process_group()
        train, valid, _ = get_mvdcndata(root_dir=root, specific_views=[0, 1], batch_size=BATCH, device="cpu",
                                        device_cache=False)
        adopt_world([train, valid], world)
        logs = _epoch(_trainer(world), train, valid)
        return {"node": (world.node, world.n_nodes), "train": train.indices.tolist(), "valid": valid.indices.tolist(),
                **{k: logs[k] for k in ("loss", "acc", "val_loss", "val_acc", "train_indices", "val_indices")}}
    finally:
        dist.destroy_process_group()


class _Joined:
    """The global batches of the nodes' pipelines: row blocks in node order."""

    def __init__(self, pipes):
        self.pipes = pipes

    def __len__(self):
        return len(self.pipes[0])

    def __iter__(self):
        for parts in zip(*self.pipes):
            batch = {k: np.concatenate([p[k] for p in parts]) for k in ("images", "labels", "indices", "mask")}
            yield {**batch, "size": int(batch["mask"].sum())}  # the real rows, which weight the metrics


def test_two_nodes_train_on_the_joined_global_batch(tmp_path):
    # 18 train-file samples: 15 train (8 a node, the second topped up with
    # the first index) and 3 validation (2 a node, topped up likewise); node
    # batches of 4, the validation batch half padding.  (With a train batch
    # of one real row a node, layer 4's 1x1 maps normalize two values a
    # channel; after such a step the validation loss of two nodes and of one
    # process, whose sums round apart by ~1e-7, differed by 38%.)
    root = make_synthetic_modelnet(str(tmp_path / "data"), n_train=18, n_test=2, num_views=2, image_size=IMG,
                                   nclasses=NC)
    ranks = run_ranks(_rank_node, 2, root, timeout=RUN_TIMEOUT, local_size=1)
    train, valid, _ = get_mvdcndata(root_dir=root, specific_views=[0, 1], batch_size=BATCH, device="cpu",
                                    device_cache=False)
    assert [r["node"] for r in ranks] == [(0, 2), (1, 2)]
    for r, node in zip(ranks, range(2)):
        assert r["train"] == parallel.process_local_indices(train.indices.tolist(), node, 2)
        assert r["valid"] == parallel.process_local_indices(valid.indices.tolist(), node, 2)
    assert len(ranks[1]["train"]) == 8 and ranks[1]["train"][-1] == train.indices[0]  # the top-up

    # the one-process trainer on the joined batches (nothing padded inside
    # the real rows of a node block; the mask marks the padding)
    pipes = [BatchPipeline(train.dataset, r["train"], BATCH, shuffle=True, seed=train.seed) for r in ranks]
    vpipes = [BatchPipeline(valid.dataset, r["valid"], BATCH) for r in ranks]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = _epoch(_trainer(None), _Joined(pipes), _Joined(vpipes))
    finally:
        torch.set_num_threads(threads)
    for r in ranks:
        for key in ("loss", "acc", "val_loss", "val_acc"):
            np.testing.assert_allclose(r[key], one[key], *LOSS_TOL, err_msg=key)
    # the gathered indices: each global batch's real rows in node order
    for pipe in pipes:
        pipe.set_epoch(0)
    want = [i for parts in zip(*pipes) for p in parts for i in p["indices"] if i >= 0]
    assert ranks[0]["train_indices"].tolist() == ranks[1]["train_indices"].tolist() == want


def test_no_environment_makes_no_group(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                "GML_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(key, raising=False)
    assert parallel.maybe_initialize_distributed() is False
    assert not dist.is_initialized()
    assert parallel.node_of_process() == (0, 1) and parallel.is_main_process()
    assert parallel.rank_device("cuda") == torch.device("cuda")  # no group: the device as named
    assert parallel.process_local_indices(range(7), 0, 1) == list(range(7))


def test_the_jax_coordinator_variable_raises(monkeypatch):
    monkeypatch.setenv("GML_COORDINATOR_ADDRESS", "127.0.0.1:1234")
    with pytest.raises(RuntimeError, match="torchrun"):
        parallel.maybe_initialize_distributed()


def _rank_init(rank):
    made = parallel.maybe_initialize_distributed(timeout=GROUP_TIMEOUT)
    try:
        again = parallel.maybe_initialize_distributed(timeout=GROUP_TIMEOUT)
        world = parallel.world_from_process_group()
        return {"made": made, "again": again, "rank": world.rank, "size": world.size, "backend": dist.get_backend(),
                "device": str(parallel.rank_device("cuda")), "cpu": str(parallel.rank_device("cpu")),
                "named": str(parallel.rank_device("cuda:0"))}
    finally:
        parallel.leave_world(made)


def test_torchrun_environment_makes_the_group():
    ranks = run_ranks(_rank_init, 2, timeout=RUN_TIMEOUT)
    for rank, r in enumerate(ranks):
        assert (r["made"], r["again"], r["rank"], r["size"], r["backend"]) == (True, False, rank, 2, "gloo")
        assert (r["device"], r["cpu"], r["named"]) == (f"cuda:{rank}", "cpu", "cuda:0")
