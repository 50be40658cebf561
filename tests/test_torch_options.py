"""The JAX package's model options and side entries in the port, on the CPU:

* ``MMTM_mitigate.SEonly`` and ``.shareweight``: the MMTM against the JAX
  module (normal, curated, flow-off: outputs, gates, squeezes, buffers),
  the JAX parameter names, no kernel path under ``use_pallas``, and the
  BDR groups of their parameters;
* ``stem_s2d``: the port runs the plain stem under the flag (the JAX
  package's space-to-depth form is a TPU layout of the same convolution):
  its stem against the JAX ``StemConv(s2d=True)`` and equal to the plain
  trunk's; odd sizes raise, as in the JAX package;
* ``remat`` in both families: one train step equals the step without it
  (gradients, parameters, statistics, rtol 1e-6) and matches the JAX
  package's remat step;
* ``pretraining``: the trunks against ``apply_pretrained_trunks`` on a
  seeded torchvision-layout file (``tests/test_pretrained.py:14-45``), in a
  ``train`` run, and its two refusals;
* ``run_api.run_entry``: train, record and flow-off in one process against
  the port's CLI in subprocesses; the bindings are cleared after a parse
  error;
* ``Trainer.enable_profiling``: one trace, of the next train epoch only."""

import csv
import functools
import json
import os
import shutil
import pickle
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from greedy_multimodal_learning_tpu import config as jax_cfg
from greedy_multimodal_learning_tpu.data.synthetic import make_synthetic_modelnet
from greedy_multimodal_learning_tpu.engine import build_train_step, create_train_state
from greedy_multimodal_learning_tpu.engine import make_optimizer as jax_make_optimizer
from greedy_multimodal_learning_tpu.engine.bdr import GroupReducer as JaxGroupReducer
from greedy_multimodal_learning_tpu.engine.controller import guided_update as jax_guided_update
from greedy_multimodal_learning_tpu.models import MMTM as JaxMMTM
from greedy_multimodal_learning_tpu.models import MMTM3DCNN as JaxMMTM3DCNN
from greedy_multimodal_learning_tpu.models import MMTMMVCNN as JaxMMTMMVCNN
from greedy_multimodal_learning_tpu.models import apply_pretrained_trunks as jax_apply_pretrained_trunks
from greedy_multimodal_learning_tpu.models import resolve_pretrained_path as jax_resolve_pretrained_path
from greedy_multimodal_learning_tpu.models.resnet import StemConv as JaxStemConv
from greedy_multimodal_learning_tpu_torch import config as port_cfg
from greedy_multimodal_learning_tpu_torch.bootstrap import init_model
from greedy_multimodal_learning_tpu_torch.data import BatchPipeline, MultiviewModelNet
from greedy_multimodal_learning_tpu_torch.engine import Trainer, make_optimizer, state_dict_from_jax
from greedy_multimodal_learning_tpu_torch.engine.bdr import group_membership
from greedy_multimodal_learning_tpu_torch.entries import train
from greedy_multimodal_learning_tpu_torch.models import (
    MMTM,
    MMTM3DCNN,
    MMTMMVCNN,
    ResNet18Trunk,
    apply_pretrained_trunks,
    build_model_from_config,
    resolve_pretrained_path,
)
from greedy_multimodal_learning_tpu_torch.models import mmtm as port_mmtm
from greedy_multimodal_learning_tpu_torch.run_api import run_entry
from test_pretrained import synth_resnet18_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NC = 4
RTOL, ATOL = 2e-5, 1e-5  # f32 MMTM, as tests/test_torch_mmtm.py
F32_TOL = (1e-4, 1e-5)  # (rtol, atol): f32 convolutions in another summation order
REMAT_RTOL = 1e-6  # remat against no remat: the same arithmetic recomputed
# A step against the JAX package's: each parameter's update in L2 within
# UPDATE_TOL (tests/test_torch_train_step.py, both families), and for the
# 3-D family the median tensor within 1e-4 (tests/test_torch_train_3d.py);
# forward quantities within FWD_TOL.  The 2-D step at these seeds has a ReLU
# input within rounding of zero on opposite sides in the two packages, which
# moves the tensors below it by ~6e-3 of their update.
UPDATE_TOL = 5e-2
FWD_TOL = (1e-4, 1e-5)
CLI_TOL = (1e-5, 1e-6)  # (rtol, atol) of tests/test_run_api.py: one process against three


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The suite runs in several worker processes at once; one thread in
    each keeps the small convolutions from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    """Each full-width checkpoint here is ~90 MB: a test's files go when it
    ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(autouse=True)
def _clean_configs():
    port_cfg.clear_config()
    jax_cfg.clear_config()
    yield
    port_cfg.clear_config()
    jax_cfg.clear_config()


# ---- SEonly and shareweight -----------------------------------------------------------

MB, MH, MC = 6, 3, 16
MASK = np.array([1, 1, 0, 1, 1, 1], np.float32)
VARIANTS = {"SEonly": dict(SEonly=True), "shareweight": dict(shareweight=True),
            "SEonly_shareweight": dict(SEonly=True, shareweight=True)}


class _NoKernel:
    @staticmethod
    def apply(*args):
        raise AssertionError("the gating kernel path was taken")


def _features(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(MB, MH, MH, MC)).astype(np.float32) for _ in range(2)]


def _run_jax(jm, variables, feats, **kw):
    (outs, scales, squeezes), mut = jm.apply(
        variables, [jnp.asarray(f) for f in feats], valid_mask=jnp.asarray(MASK), return_scale=True,
        return_squeezed_mps=True, mutable=["mmtm"], **kw)
    return [np.asarray(o) for o in outs], scales, squeezes, mut["mmtm"]


def _run_torch(tm, feats, **kw):
    x = [torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats]
    with torch.no_grad():
        outs, scales, squeezes = tm(x, valid_mask=torch.from_numpy(MASK), return_scale=True,
                                    return_squeezed_mps=True, **kw)
    return [o.permute(0, 2, 3, 1).numpy() for o in outs], scales, squeezes


@pytest.mark.parametrize("mode", ["normal", "curated", "flow_off"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_mmtm_variant_matches_jax(monkeypatch, variant, mode):
    """Loaded with ``strict=True`` from the JAX parameters: the names are the
    JAX package's.  ``use_pallas=True`` on both sides takes no kernel."""
    monkeypatch.setattr(port_mmtm, "MMTMGatingFunction", _NoKernel)
    kw = VARIANTS[variant]
    jm = JaxMMTM(dims=[MC, MC], use_pallas=True, **kw)
    variables = jm.init(jax.random.PRNGKey(0), [jnp.asarray(f) for f in _features(0)])
    tm = MMTM(dims=[MC, MC], use_pallas=True, **kw)
    tm.load_state_dict(state_dict_from_jax(variables["params"], {}, variables["mmtm"]), strict=True)
    warm = _features(1)
    variables = {**variables, "mmtm": _run_jax(jm, variables, warm)[3]}
    _run_torch(tm, warm)
    call = {}
    if mode == "curated":
        call = dict(curation_mode=True, caring_modality=1)
    elif mode == "flow_off":
        avg = [np.abs(np.random.default_rng(7).normal(size=(MC,))).astype(np.float32) for _ in range(2)]
        call = dict(turnoff_cross_modal_flow=True, average_squeezemaps=avg)
    feats = _features(2)
    jax_res = _run_jax(jm, variables, feats, **{
        k: (jnp.asarray(v) if k != "average_squeezemaps" else [jnp.asarray(a) for a in v]) for k, v in call.items()})
    torch_res = _run_torch(tm, feats, **{
        k: (torch.tensor(v) if k != "average_squeezemaps" else [torch.from_numpy(a) for a in v])
        for k, v in call.items()})
    for i in range(2):
        for what, got, want in (("out", torch_res[0], jax_res[0]), ("gate", torch_res[1], jax_res[1]),
                                ("squeeze", torch_res[2], jax_res[2])):
            np.testing.assert_allclose(np.asarray(got[i]), np.asarray(want[i]), RTOL, ATOL, err_msg=f"{what}{i}")
    for name in ("running_avg_visual", "running_avg_skeleton", "step"):
        np.testing.assert_allclose(getattr(tm, name).numpy(), np.asarray(jax_res[3][name]), RTOL, ATOL, err_msg=name)


def test_variant_bdr_groups():
    """``fc_squeeze_<name>`` counts for its own modality's bypass group, the
    shared ``fc_excite`` for every modality's (``engine/bdr.py:35-59``)."""
    port = MMTMMVCNN(nclasses=NC, SEonly=True, shareweight=True)
    names = [n for n, _ in port.named_parameters() if n.startswith("mmtm")]
    assert sorted({n.split(".")[1] for n in names}) == ["fc_excite", "fc_squeeze_skeleton", "fc_squeeze_visual"]
    rows = dict(zip(names, group_membership(names, ["net_view_0", "net_view_1"], ["visual", "skeleton"])))
    for k in (2, 3, 4):
        for p in ("weight", "bias"):
            assert rows[f"mmtm{k}.fc_squeeze_visual.{p}"] == (0, 0, 1, 0)
            assert rows[f"mmtm{k}.fc_squeeze_skeleton.{p}"] == (0, 0, 0, 1)
            assert rows[f"mmtm{k}.fc_excite.{p}"] == (0, 0, 1, 1)


# ---- the space-to-depth stem --------------------------------------------------------------


@pytest.mark.parametrize("size", [32, 30])
def test_stem_s2d_matches_jax_and_the_plain_stem(size):
    x = np.random.default_rng(size).normal(size=(2, size, size, 3)).astype(np.float32)
    jstem = JaxStemConv(features=64, s2d=True)
    variables = jstem.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(jstem.apply(variables, jnp.asarray(x)))
    trunk = ResNet18Trunk(NC, stem_s2d=True)
    plain = ResNet18Trunk(NC)
    plain.load_state_dict(trunk.state_dict())
    weight = torch.from_numpy(np.transpose(np.asarray(variables["params"]["kernel"]), (3, 2, 0, 1)).copy())
    with torch.no_grad():
        trunk.conv1.weight.copy_(weight)
        plain.conv1.weight.copy_(weight)
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = trunk.conv1(xt)
        assert torch.equal(trunk.stem(xt), plain.stem(xt))
    assert got.shape == (2, 64, size // 2, size // 2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, *F32_TOL)
    assert trunk.conv1.weight.shape == (64, 3, 7, 7)
    with pytest.raises(ValueError, match="even spatial"):
        trunk.stem(torch.zeros(1, 3, size + 1, size))
    plain.stem(torch.zeros(1, 3, size + 1, size))  # the plain stem takes any size


def test_stem_s2d_model_matches_the_plain_model():
    """The whole model with ``stem_s2d`` on the plain model's weights."""
    plain = init_model(MMTMMVCNN(nclasses=NC), 0, "cpu")
    s2d = init_model(MMTMMVCNN(nclasses=NC, stem_s2d=True), 1, "cpu")
    s2d.load_state_dict(plain.state_dict())
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 2, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        _, want, _, _ = plain(x, mmtm_state={})
        _, got, _, _ = s2d(x, mmtm_state={})
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---- remat --------------------------------------------------------------------------------

B = 4
STEP_MASK = np.array([1, 1, 1, 0], np.float32)
FIELDS = ("M_main", "M_bypass", "curation_mode", "caring_modality", "curation_step", "d_BDR")
FAMILIES = {
    "2d": dict(jax=lambda remat: JaxMMTMMVCNN(nclasses=NC, remat=remat),
               port=lambda remat: MMTMMVCNN(nclasses=NC, remat=remat), shape=(B, 2, 32, 32, 3), flips=(B, 2),
               branches=["net_view_0", "net_view_1"], names=["visual", "skeleton"], median_tol=None),
    "3d": dict(jax=lambda remat: JaxMMTM3DCNN(nclasses=NC, num_towers=3, width_multiplier=0.25, remat=remat),
               port=lambda remat: MMTM3DCNN(nclasses=NC, width_multiplier=0.25, remat=remat),
               shape=(B, 3, 4, 32, 32, 3), flips=(B,), branches=["net_view_0", "net_view_1", "net_view_2"],
               names=["rgb", "depth", "flow"], median_tol=1e-4),
}


def _step_batch(shape, seed=5):
    rng = np.random.default_rng(seed)
    return {"images": rng.integers(0, 256, shape, dtype=np.uint8),
            "labels": rng.integers(0, NC, shape[0]).astype(np.int32), "mask": STEP_MASK}


def _port_step(fam, remat, state_dict, batch, flips):
    model = fam["port"](remat)
    model = model.to(memory_format=model.memory_format)
    model.load_state_dict(state_dict, strict=False)
    n = len(fam["names"])
    trainer = Trainer(model, make_optimizer(model.parameters(), lr=0.05, momentum=0.9), controller_kind="guided",
                      controller_config={"epsilon": 1e-3, "curation_windowsize": 2, "branchnames": fam["branches"],
                                         "mmtm_names": fam["names"]}, nummodalities=n, device="cpu")
    out = trainer.train_batch({k: torch.from_numpy(v) for k, v in batch.items()}, torch.from_numpy(flips),
                              torch.tensor(True))
    return trainer, out


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def remat_steps(request):
    """The JAX package's remat model, its state and one jitted guided step
    from it, and the port's step on the same state with and without remat,
    with the JAX package's flips."""
    fam = FAMILIES[request.param]
    model = fam["jax"](True)
    opt = jax_make_optimizer(lr=0.05, momentum=0.9)
    n = len(fam["names"])
    state = create_train_state(model, opt, jax.random.PRNGKey(2), jnp.zeros(fam["shape"]), num_modalities=n)
    update = functools.partial(jax_guided_update, epsilon=1e-3, curation_windowsize=2)
    step = build_train_step(model, opt, JaxGroupReducer(state.params, fam["branches"], fam["names"]), update,
                            donate=False)
    batch = _step_batch(fam["shape"])
    flips = np.array(jax.random.bernoulli(jax.random.fold_in(state.rng, state.step), 0.5, fam["flips"]))
    before = state_dict_from_jax(state.params, state.batch_stats, state.mmtm)
    new_state, j_out = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(True))
    ports = {remat: _port_step(fam, remat, before, batch, flips) for remat in (False, True)}
    return fam, before, new_state, j_out, ports


def test_remat_step_equals_the_plain_step(remat_steps):
    """Gradients, updated parameters, BatchNorm statistics (updated once a
    forward, not again by the recompute) and MMTM buffers."""
    _, _, _, _, ports = remat_steps
    (plain, p_out), (remat, r_out) = ports[False], ports[True]
    assert remat.model.net_view_0.remat and not plain.model.net_view_0.remat
    np.testing.assert_allclose(r_out["loss"].numpy(), p_out["loss"].numpy(), rtol=REMAT_RTOL)
    grads = {n: p.grad for n, p in plain.model.named_parameters()}
    for n, p in remat.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[n].numpy(), rtol=REMAT_RTOL, atol=1e-9, err_msg=n)
    want = plain.model.state_dict()
    for key, value in remat.model.state_dict().items():
        np.testing.assert_allclose(value.double().numpy(), want[key].double().numpy(), rtol=REMAT_RTOL, atol=1e-9,
                                   err_msg=key)


def test_remat_step_matches_jax(remat_steps):
    fam, before, new_state, j_out, ports = remat_steps
    trainer, t_out = ports[True]
    for key in ("loss", "acc", "acc_modal"):
        np.testing.assert_allclose(t_out[key].numpy(), np.asarray(j_out[key]), *FWD_TOL, err_msg=key)
    after, got = state_dict_from_jax(new_state.params, new_state.batch_stats, new_state.mmtm), trainer.model.state_dict()
    params, ratios = {n for n, _ in trainer.model.named_parameters()}, []
    for key, want in after.items():
        if key in params:
            err, update = float((got[key] - want).norm()), float((want - before[key]).norm())
            assert err <= UPDATE_TOL * update + 1e-7, (key, err, update)
            ratios.append(err / max(update, 1e-30))
        else:
            np.testing.assert_allclose(got[key].numpy(), want.numpy(), *FWD_TOL, err_msg=key)
    if fam["median_tol"] is not None:
        assert np.median(ratios) <= fam["median_tol"], np.median(ratios)


# ---- pretraining --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    sd = {k: torch.from_numpy(np.array(v)) for k, v in synth_resnet18_state_dict(np.random.default_rng(3)).items()}
    base = tmp_path_factory.mktemp("pretrained")
    paths = {}
    for wrap in ("bare", "state_dict", "model"):
        paths[wrap] = str(base / f"resnet18-{wrap}.pt")
        torch.save(sd if wrap == "bare" else {wrap: sd}, paths[wrap])
    yield sd, paths
    shutil.rmtree(base, ignore_errors=True)


@pytest.mark.parametrize("wrap", ["bare", "state_dict", "model"])
def test_pretrained_trunks_match_jax(weights, wrap):
    sd, paths = weights
    jmodel = JaxMMTMMVCNN(nclasses=NC)
    state = create_train_state(jmodel, jax_make_optimizer(lr=0.1), jax.random.PRNGKey(0), jnp.zeros((2, 2, 32, 32, 3)))
    state = jax_apply_pretrained_trunks(state, paths[wrap], 2)
    want = state_dict_from_jax(state.params, state.batch_stats)
    port = init_model(MMTMMVCNN(nclasses=NC), 0, "cpu")
    fresh = {k: v.clone() for k, v in port.state_dict().items()}
    apply_pretrained_trunks(port, paths[wrap], 2)
    got = port.state_dict()
    for key, value in got.items():
        tower_key = key.split(".", 1)[1] if key.startswith("net_view_") else None
        if tower_key in sd and not (tower_key.startswith("fc.") or tower_key.endswith("num_batches_tracked")):
            assert torch.equal(value, sd[tower_key]) and torch.equal(value, want[key]), key
        else:  # the heads, the MMTMs and num_batches_tracked keep their initialization
            assert torch.equal(value, fresh[key]), key


def test_pretraining_in_a_train_run(weights, tmp_path):
    """``train`` with ``MMTM_MVCNN.pretraining``: every tower's trunk is the
    file's before the first step, its ``fc`` the seeded head; one epoch runs."""
    sd, paths = weights
    root = make_synthetic_modelnet(str(tmp_path / "d"), n_train=6, n_test=2, num_views=2, image_size=32, nclasses=NC)
    port_cfg.parse_config_files_and_bindings([os.path.join(REPO, "configs", "training_guided.gin")], "\n".join([
        f"get_mvdcndata.root_dir='{root}'", "get_mvdcndata.specific_views=[0, 1]", f"MMTM_MVCNN.nclasses={NC}",
        "MMTM_MVCNN.pretraining=True", f"MMTM_MVCNN.pretrained_weights_path='{paths['model']}'",
        "train.device='cpu'", "train.batch_size=4", "training_loop.n_epochs=2"]))
    seen = {}
    original = Trainer.train_loop

    def spy(self, *args, **kwargs):
        seen.update({k: v.clone() for k, v in self.model.state_dict().items()})
        return original(self, *args, **kwargs)

    Trainer.train_loop = spy
    try:
        trainer = train(str(tmp_path / "run"))
    finally:
        Trainer.train_loop = original
    head = init_model(MMTMMVCNN(nclasses=NC), 777, "cpu").state_dict()
    for i in range(2):
        for key, value in sd.items():
            if not key.startswith("fc.") and not key.endswith("num_batches_tracked"):
                assert torch.equal(seen[f"net_view_{i}.{key}"], value), key
        assert torch.equal(seen[f"net_view_{i}.fc.weight"], head[f"net_view_{i}.fc.weight"])
    assert trainer.step >= 1
    with open(tmp_path / "run" / "history.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1 and np.isfinite(float(rows[0]["loss"]))


def test_pretraining_refusals_match_jax(monkeypatch, tmp_path):
    monkeypatch.delenv("GML_PRETRAINED_RESNET18", raising=False)
    for binding, error in (("", NotImplementedError),
                           (f"\nMMTM_MVCNN.pretrained_weights_path = '{tmp_path}/nope.pt'", FileNotFoundError)):
        text = "MMTM_MVCNN.pretraining = True" + binding
        jax_cfg.parse_config(text)
        port_cfg.parse_config(text)
        with pytest.raises(error) as jax_err:
            jax_resolve_pretrained_path()
        with pytest.raises(error) as port_err:
            resolve_pretrained_path()
        assert str(port_err.value) == str(jax_err.value)
        with pytest.raises(error):
            build_model_from_config()
        jax_cfg.clear_config()
        port_cfg.clear_config()


# ---- run_entry ----------------------------------------------------------------------------


def _phases(save, root):
    data = [f"MMTM_MVCNN.nclasses={NC}", f"get_mvdcndata.root_dir='{root}'", "get_mvdcndata.specific_views=[0, 1]"]
    ckpt = os.path.join(save, "model_last_epoch.pt")
    rec = data + [f"eval_.pretrained_weights_path='{ckpt}'", "eval_.batch_size=4", "eval_.device='cpu'"]
    return [
        ("train", save, "configs/training_guided.gin",
         "#".join(data + ["train.batch_size=4", "train.device='cpu'", "training_loop.n_epochs=3"])),
        ("eval", save, "configs/recording.gin", "#".join(rec)),
        ("eval", os.path.join(save, "off"), "configs/eval.gin", "#".join(rec + [
            f"MMTM_MVCNN.mmtm_rescale_eval_file_path='{os.path.join(save, 'eval_history_batch')}'",
            f"MMTM_MVCNN.mmtm_rescale_training_file_path='{save}'"])),
    ]


def _leaves(x):
    if isinstance(x, (list, tuple)):
        for y in x:
            yield from _leaves(y)
    else:
        yield np.asarray(x)


def test_run_entry_matches_the_cli(tmp_path):
    """Train, record and flow-off through ``run_entry`` in this process
    against the port's CLI in three subprocesses (``tests/test_run_api.py``):
    the same history, recording and flow-off metrics."""
    root = make_synthetic_modelnet(str(tmp_path / "data"), n_train=10, n_test=4, num_views=2, image_size=32,
                                   nclasses=NC)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    for entry, save, config, bindings in _phases(str(tmp_path / "cli"), root):
        r = subprocess.run([sys.executable, "-m", f"greedy_multimodal_learning_tpu_torch.{entry}", save, config,
                            bindings], cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
        assert r.returncode == 0, r.stderr[-3000:]
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        for entry, save, config, bindings in _phases(str(tmp_path / "api"), root):
            run_entry(entry, save, config, bindings)
            assert port_cfg.CONFIG == {}
    finally:
        os.chdir(cwd)
    a, b = str(tmp_path / "cli"), str(tmp_path / "api")
    for sub in ("", "eval_history_batch", os.path.join("off", "eval_history_batch")):
        with open(os.path.join(a, sub, "history.csv")) as f:
            ra = list(csv.DictReader(f))
        with open(os.path.join(b, sub, "history.csv")) as f:
            rb = list(csv.DictReader(f))
        assert len(ra) == len(rb) and list(ra[0]) == list(rb[0])
        for x, y in zip(ra, rb):
            for col in x:
                if not (col.endswith("time") or "per_sec" in col):
                    np.testing.assert_allclose(float(x[col]), float(y[col]), *CLI_TOL, err_msg=f"{sub} {col}")
    with open(os.path.join(a, "eval_history_batch", "history.pickle"), "rb") as f:
        pa = pickle.load(f)
    with open(os.path.join(b, "eval_history_batch", "history.pickle"), "rb") as f:
        pb = pickle.load(f)
    np.testing.assert_array_equal(np.concatenate(pa["test_indices"]), np.concatenate(pb["test_indices"]))
    for x, y in zip(_leaves(pa["test_squeezedmaps_array_list"]), _leaves(pb["test_squeezedmaps_array_list"])):
        np.testing.assert_allclose(y, x, *CLI_TOL)
    for name in ("operative_config.gin", "stdout.txt", "model_last_epoch.pt"):
        assert os.path.exists(os.path.join(b, name)), name


def test_run_entry_clears_the_bindings_after_a_parse_error(tmp_path):
    with pytest.raises(Exception):
        run_entry("train", str(tmp_path / "bad"), os.path.join(REPO, "configs", "training_random.gin"),
                  "train.batch_size=4#this is not a binding")
    assert port_cfg.query("train", "batch_size") is None and port_cfg.CONFIG == {}
    with pytest.raises(ValueError, match="entry must be one of"):
        run_entry("predict", str(tmp_path / "p"), os.path.join(REPO, "configs", "training_random.gin"))


# ---- enable_profiling ---------------------------------------------------------------------


def test_enable_profiling_traces_the_next_epoch_only(tmp_path):
    root = make_synthetic_modelnet(str(tmp_path / "d"), n_train=8, n_test=4, num_views=2, image_size=32, nclasses=NC)
    ds = MultiviewModelNet(root, "train", specific_view=[0, 1])
    loader = BatchPipeline(ds, range(8), 4, shuffle=True, seed=1)
    model = init_model(MMTMMVCNN(nclasses=NC), 0, "cpu")
    trainer = Trainer(model, make_optimizer(model.parameters(), lr=0.01), device="cpu", verbose=False)
    trace_dir = tmp_path / "trace"
    trainer.enable_profiling(str(trace_dir))
    trainer.train_loop(loader, epochs=2, steps_per_epoch=len(loader))
    files = sorted(os.listdir(trace_dir))
    assert files == ["train_steps_0-1.trace.json"] and trainer.profile_dir is None
    with open(trace_dir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("convolution" in e.get("name", "") for e in events)
    trainer.enable_profiling(str(trace_dir))
    trainer.train_loop(loader, epochs=3, steps_per_epoch=len(loader), initial_epoch=3)
    assert sorted(os.listdir(trace_dir)) == ["train_steps_0-1.trace.json", "train_steps_4-5.trace.json"]
