"""The port's eval pass under curation against the JAX package's (CPU).

The random and guided controllers' eval passes run under the curation
flags the last train step left: with ``bug_compat`` the cared modality's
gate becomes the running average of modality 0's gates (``models/mmtm.py``
of both packages; the JAX package's ``:225-262``), and the running averages
move on every eval forward (quirk #6).  A 2-D random run's val accuracy of
modality 1 at an epoch end therefore follows that epoch's last draw
(``tests/test_torch_random_draws.py``).  Here both packages start an eval
pass from the same weights (``state_dict_from_jax``), the same MMTM
running averages and step counter and the same flags, over a split of 22
batches of 4 whose last holds 2 (the mask keeps the padded rows out of the
gate means): the JAX package's per-step eval, its scanned eval (``jit``,
K = 10: two groups of 10, then the per-step program for the tail) and the
port's ``Trainer.eval_loop`` give the same per-modality accuracies, and
the loss and the running averages after the pass within the tolerances of
``tests/test_torch_parity.py``, for curation of modality 1, of modality 0
and none."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from greedy_multimodal_learning_tpu.data import MultiviewModelNet as JaxModelNet
from greedy_multimodal_learning_tpu.data.pipeline import BatchPipeline as JaxPipeline
from greedy_multimodal_learning_tpu.data.synthetic import make_synthetic_modelnet
from greedy_multimodal_learning_tpu.engine import Trainer as JaxTrainer
from greedy_multimodal_learning_tpu.engine import create_train_state, make_optimizer
from greedy_multimodal_learning_tpu.models import MMTMMVCNN as JaxMMTMMVCNN
from greedy_multimodal_learning_tpu_torch.data import BatchPipeline, MultiviewModelNet
from greedy_multimodal_learning_tpu_torch.engine import Trainer, state_dict_from_jax
from greedy_multimodal_learning_tpu_torch.engine.callbacks import LambdaCallback
from greedy_multimodal_learning_tpu_torch.models import MMTMMVCNN

IMG, NC, BATCH = 32, 4, 4
N_TEST = 86  # 21 batches of 4 and a last one of 2
SCAN = 10  # the JAX trainer's eval_scan_size: 22 steps >= 2 K take the scanned path
START_STEP = 37.0  # the MMTM step counter a pass starts from
# Each tower's classifier scaled up, so that the logits (near 0 at init)
# and with them the loss and accuracies answer to the gates
FC_SCALE = 30.0
LOSS_RTOL = 1e-4  # tests/test_torch_parity.py:165
STAT_RTOL, STAT_ATOL = 1e-3, 1e-5  # MMTM running averages, tests/test_torch_parity.py:199-206
# (curation_mode, caring_modality): modality 1 curated (the random
# controller's mode 1), modality 0 (mode 2), and none (mode 0)
FLAGS = {"modality 1": (True, 1), "modality 0": (True, 0), "off": (False, 0)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The suite runs in several worker processes at once; one thread in
    each keeps the small convolutions from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _start_mmtm(mmtm):
    """The JAX model's MMTM collection with seeded running averages in
    [0.2, 0.8] and the step counter at ``START_STEP``."""
    rng = np.random.default_rng(3)
    out = {}
    for site, leaves in mmtm.items():
        out[site] = {name: (jnp.asarray(START_STEP, jnp.float32) if name == "step"
                            else jnp.asarray(rng.uniform(0.2, 0.8, np.shape(leaf)).astype(np.float32)))
                     for name, leaf in leaves.items()}
    return out


@pytest.fixture(scope="module")
def passes(tmp_path_factory):
    """Each FLAGS case's pass in the JAX package (per step and scanned)
    and in the port: {case: {"per_step" | "scanned" | "port": (metrics,
    the MMTM buffers after the pass as the port's state_dict entries)}}."""
    root = make_synthetic_modelnet(str(tmp_path_factory.mktemp("data")), n_train=4, n_test=N_TEST, num_views=2,
                                   image_size=IMG, nclasses=NC)
    jax_ds, port_ds = JaxModelNet(root, "test", specific_view=[0, 1]), MultiviewModelNet(root, "test",
                                                                                      specific_view=[0, 1])
    assert len(jax_ds) == N_TEST

    model = JaxMMTMMVCNN(nclasses=NC, num_towers=2)
    state = create_train_state(model, make_optimizer(lr=0.1), jax.random.PRNGKey(0),
                               jnp.zeros((BATCH, 2, IMG, IMG, 3)))
    params = dict(state.params)
    for tower in ("net_view_0", "net_view_1"):
        fc = dict(params[tower]["fc"], kernel=params[tower]["fc"]["kernel"] * FC_SCALE)
        params[tower] = dict(params[tower], fc=fc)
    state = state.replace(params=params, mmtm=_start_mmtm(state.mmtm))
    jt = JaxTrainer(model, None, state, controller_kind="random", verbose=False)
    jt.eval_scan_size = SCAN
    scanned_step = jt._eval_scan_step
    assert scanned_step is not None
    weights = state_dict_from_jax(state.params, state.batch_stats, state.mmtm)

    port_model = MMTMMVCNN(nclasses=NC)
    port_model = port_model.to(memory_format=port_model.memory_format)
    port_model.load_state_dict(weights)
    port = Trainer(port_model, controller_kind="random", device="cpu", verbose=False)

    out = {}
    for case, (mode, caring) in FLAGS.items():
        ctrl = state.controller.replace(curation_mode=jnp.asarray(mode), caring_modality=jnp.asarray(caring, jnp.int32))
        out[case] = {}
        for path, step in (("per_step", None), ("scanned", scanned_step)):
            jt.state = state.replace(controller=ctrl)
            jt._eval_scan_step = step
            info = jt._eval_generator(JaxPipeline(jax_ds, list(range(N_TEST)), BATCH, shuffle=False), "test")
            out[case][path] = (info, state_dict_from_jax({}, {}, jax.device_get(jt.state.mmtm)))

        port_model.load_state_dict(weights)
        port.ctrl.curation_mode = torch.tensor(mode)
        port.ctrl.caring_modality = torch.tensor(caring, dtype=torch.int32)
        logs = []
        port.eval_loop(BatchPipeline(port_ds, range(N_TEST), BATCH, shuffle=False), epochs=0,
                       callbacks=[LambdaCallback(on_epoch_end=lambda epoch, log: logs.append(dict(log)))])
        buffers = {k: v.clone() for k, v in port_model.state_dict().items()
                   if k.startswith("mmtm") and (".running_avg_" in k or k.endswith(".step"))}
        out[case]["port"] = (logs[0], buffers)
    return out


@pytest.mark.parametrize("path", ["per_step", "scanned"])
@pytest.mark.parametrize("case", sorted(FLAGS))
def test_the_eval_pass_under_curation_matches_jax(passes, case, path):
    want, want_mmtm = passes[case][path]
    got, got_mmtm = passes[case]["port"]
    assert len(got["test_indices"]) == N_TEST
    np.testing.assert_array_equal(got["test_indices"], want["test_indices"])
    for key in ("test_acc", "test_acc_modal_0", "test_acc_modal_1"):
        assert got[key] == pytest.approx(want[key], rel=1e-12), key
    np.testing.assert_allclose(got["test_loss"], want["test_loss"], rtol=LOSS_RTOL)
    assert sorted(got_mmtm) == sorted(want_mmtm)
    for key, value in want_mmtm.items():
        if key.endswith(".step"):
            assert float(got_mmtm[key]) == float(value) == START_STEP + N_TEST // BATCH + 1, key
        else:
            np.testing.assert_allclose(got_mmtm[key].numpy(), value.numpy(), rtol=STAT_RTOL, atol=STAT_ATOL,
                                       err_msg=key)


def test_curation_moves_the_pass(passes):
    """The cases differ, so the comparisons above see the select: each
    curated pass gives another loss and other accuracies than the pass
    without curation, and the two curated passes differ from each other,
    beyond the tolerances above.  The first MMTM's running averages end
    the same under every flag (they are taken from the live gates, before
    the select); the later sites' differ, as their inputs passed through a
    curated site."""
    logs = {case: passes[case]["port"][0] for case in FLAGS}
    for case in FLAGS:
        for path in ("port", "per_step", "scanned"):
            log = passes[case][path][0]
            print(case, path, *(f"{k} {log[k]:.6g}" for k in ("test_loss", "test_acc_modal_0", "test_acc_modal_1")))
    buffers = {case: passes[case]["port"][1] for case in FLAGS}
    for a, b in (("modality 1", "off"), ("modality 0", "off"), ("modality 1", "modality 0")):
        assert abs(logs[a]["test_loss"] - logs[b]["test_loss"]) > 100 * LOSS_RTOL * abs(logs[b]["test_loss"]), (a, b)
        assert any(logs[a][k] != logs[b][k] for k in ("test_acc_modal_0", "test_acc_modal_1")), (a, b)
        for key, value in buffers[a].items():
            same = np.allclose(value.numpy(), buffers[b][key].numpy(), rtol=STAT_RTOL, atol=STAT_ATOL)
            assert same == (key.startswith("mmtm2.") or key.endswith(".step")), (a, b, key)
