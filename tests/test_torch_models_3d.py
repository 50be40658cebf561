"""The port's 3-modality 3D-CNN family against the JAX package's, on the CPU,
at the shapes of the JAX package's own 3D tests (``tests/test_models_3d.py``:
3 modalities, width 0.25, 4 frames of 16², 4 classes), B=4 with a padded
row:

* the masked BatchNorm on 5-D maps against ``TorchBatchNorm`` (outputs and
  running statistics), and the seeded init of 3-D convolutions;
* the clip flip (one per sample, shared across modalities) against the JAX
  ``preprocess`` given the same (B,) mask;
* ``ResNet3D18Trunk`` (eval, train) and ``MMTM3DCNN`` (eval, train curating
  each modality, flow-off with averages) against the JAX modules on weights
  carried by ``state_dict_from_jax`` (5-D kernels transposed);
* 3D checkpoints across the packages in both directions, with no missing key;
* ``make_synthetic_nvgesture`` writes the JAX package's files byte for byte;
* ``remat=True`` builds in both families and its train step is the step
  without it;
* the entry's model dispatch and its channels-last-3d memory format."""

import filecmp
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from greedy_multimodal_learning_tpu.data.nvgesture import make_synthetic_nvgesture as jax_make_synthetic
from greedy_multimodal_learning_tpu.data.transforms import preprocess as jax_preprocess
from greedy_multimodal_learning_tpu.engine import create_train_state
from greedy_multimodal_learning_tpu.engine.checkpoint import load_pretrained
from greedy_multimodal_learning_tpu.engine.checkpoint import save_weights as jax_save_weights
from greedy_multimodal_learning_tpu.models import MMTM3DCNN as JaxMMTM3DCNN
from greedy_multimodal_learning_tpu.models import ResNet3D18Trunk as JaxTrunk
from greedy_multimodal_learning_tpu.models.layers import TorchBatchNorm
from greedy_multimodal_learning_tpu_torch import config as port_cfg
from greedy_multimodal_learning_tpu_torch.bootstrap import build_model_and_loaders, init_model
from greedy_multimodal_learning_tpu_torch.data.nvgesture import make_synthetic_nvgesture
from greedy_multimodal_learning_tpu_torch.data.transforms import draw_flips, flip_shape, preprocess
from greedy_multimodal_learning_tpu_torch.engine import Trainer, load_weights, make_optimizer, save_weights, state_dict_from_jax
from greedy_multimodal_learning_tpu_torch.models import (
    BatchNorm3d,
    init_parameters,
    MMTM3DCNN,
    ResNet3D18Trunk,
    build_3dcnn_from_config,
    build_model_from_config,
)
from greedy_multimodal_learning_tpu_torch.utils import prng

B, M, T, IMG, NC, WIDTH = 4, 3, 4, 16, 4, 0.25
# Train-mode forwards run at 32²: at 16² layer group 4's maps are 1x1x1, so
# its masked batch statistics cover 3 values a channel, the padded row
# normalizes to ~100 and f32 rounding is amplified ~1000-fold; at 32² they
# cover 12 values and the two packages agree within the f32 tolerance.
IMG_TRAIN = 32
MASK = np.array([1, 1, 1, 0], np.float32)  # row 3 is padding
RTOL, ATOL = 1e-4, 1e-5  # f32: the same arithmetic in another summation order
NAMES = ("rgb", "depth", "flow")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The suite runs in several worker processes at once; one thread in
    each keeps the small convolutions from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_port_config():
    port_cfg.clear_config()
    yield
    port_cfg.clear_config()


def _clips(seed, batch=B, img=IMG):
    """A normalized (B, M, T, H, W, C) clip batch."""
    return np.random.default_rng(seed).normal(size=(batch, M, T, img, img, 3)).astype(np.float32)


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=rtol, atol=atol,
                               err_msg=what)


def _to_ncthw(x):
    return torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous(memory_format=torch.channels_last_3d)


# ---- layers ------------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_5d_batchnorm_matches_jax(masked, dtype):
    C = 8
    rng = np.random.default_rng(0)
    scale, bias = rng.uniform(0.5, 1.5, C).astype(np.float32), rng.normal(size=C).astype(np.float32)
    mean, var = rng.normal(size=C).astype(np.float32), rng.uniform(0.5, 2.0, C).astype(np.float32)
    jvars = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean, "var": var}}
    bn = BatchNorm3d(C)
    bn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean), "running_var": torch.from_numpy(var)}, strict=False)
    x = (3.0 * rng.normal(size=(B, 3, 5, 4, C)) + 1.0).astype(np.float32)
    x = torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()  # both sides see the same values
    mask = MASK if masked else None
    y, mut = TorchBatchNorm(dtype=jnp.dtype(dtype)).apply(
        jvars, jnp.asarray(x).astype(jnp.dtype(dtype)), use_running_average=False,
        mask=None if mask is None else jnp.asarray(mask), mutable=["batch_stats"],
    )
    got = bn(_to_ncthw(x).to(getattr(torch, dtype)), train=True, mask=None if mask is None else torch.from_numpy(mask))
    assert got.dtype == getattr(torch, dtype)
    # bf16 output: one bf16 ulp (2^-7 relative) where f32 values straddle a rounding boundary
    rtol = RTOL if dtype == "float32" else 8e-3
    _close(got.detach().float().permute(0, 2, 3, 4, 1).numpy(), y.astype(jnp.float32), "output", rtol=rtol)
    _close(bn.running_mean.numpy(), mut["batch_stats"]["mean"], "running mean")
    _close(bn.running_var.numpy(), mut["batch_stats"]["var"], "running var")
    eval_y = TorchBatchNorm().apply({"params": jvars["params"], "batch_stats": mut["batch_stats"]}, jnp.asarray(x),
                                    use_running_average=True)
    _close(bn(_to_ncthw(x), train=False).detach().permute(0, 2, 3, 4, 1).numpy(), eval_y, "eval output")


def test_conv3d_takes_the_kaiming_fan_out_init():
    """``init_parameters`` reaches 3-D convolutions: std sqrt(2 / fan_out)
    with fan_out = O * 3 * 7 * 7 for the stem (torch's default init would
    give a uniform of std sqrt(1 / (3 fan_in))); under one key a trunk takes
    flax's draws (``ResNet3D18Trunk.init``): the convolutions within 4
    float32 ulps (``tests/test_torch_prng.py``), the rest bit for bit."""
    trunk = ResNet3D18Trunk(NC)
    init_parameters(trunk, prng.PRNGKey(0))
    w = trunk.conv1.weight
    assert w.shape == (64, 3, 3, 7, 7)
    want = (2.0 / (64 * 3 * 7 * 7)) ** 0.5
    assert abs(float(w.std()) / want - 1.0) < 0.03
    assert float(trunk.layer2[0].downsample[1].weight.min()) == 1.0  # BatchNorm3d: ones/zeros
    small = ResNet3D18Trunk(NC, WIDTH)
    init_parameters(small, prng.PRNGKey(0))
    variables = JaxTrunk(nclasses=NC, width_multiplier=WIDTH).init(jax.random.PRNGKey(0),
                                                                    jnp.asarray(_clips(1, img=IMG)[:, 0]), train=False)
    got = small.state_dict()
    for name, value in state_dict_from_jax(variables["params"], variables["batch_stats"]).items():
        a, b = got[name].numpy(), value.numpy()
        if a.ndim == 5:
            assert np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64)).max() <= 4, name
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


# ---- the clip flip -------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_flip_matches_jax(dtype):
    """One flip per sample, shared across its modalities, given JAX's (B,) draw."""
    clips = np.random.default_rng(4).integers(0, 256, (5, M, T, 6, 7, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(9)
    want = jax_preprocess(jnp.asarray(clips), train=True, rng=key, dtype=jnp.dtype(dtype))
    flips = np.asarray(jax.random.bernoulli(key, 0.5, (5,)))  # transforms.py:49
    assert 0 < flips.sum() < 5
    got = preprocess(torch.from_numpy(clips), train=True, flip=torch.from_numpy(flips), dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_clip_flips_are_drawn_per_sample():
    clips = torch.zeros((4, M, T, 3, 3, 3), dtype=torch.uint8)
    assert flip_shape(clips.shape) == (4,) and flip_shape((4, 2, 3, 3, 3)) == (4, 2)
    key = prng.PRNGKey(1)
    np.testing.assert_array_equal(draw_flips((4,), key).numpy(), np.asarray(jax.random.bernoulli(key, 0.5, (4,))))
    a = preprocess(clips, train=True, key=key)
    b = preprocess(clips, train=True, key=prng.PRNGKey(1))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="flip mask"):
        preprocess(clips, train=True, flip=torch.zeros((4, M), dtype=torch.bool))


# ---- the trunk and the model against the JAX modules ---------------------------------------


def _trunk_pair(img=IMG):
    x = _clips(1, img=img)[:, 0]
    jmodel = JaxTrunk(nclasses=NC, width_multiplier=WIDTH)
    variables = jmodel.init(jax.random.PRNGKey(2), jnp.asarray(x), train=False)
    trunk = ResNet3D18Trunk(NC, WIDTH).to(memory_format=torch.channels_last_3d)
    missing, unexpected = trunk.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]),
                                                strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    return x, jmodel, variables, trunk


def test_state_dict_from_jax_transposes_5d_kernels():
    _, _, variables, trunk = _trunk_pair()
    kernel = np.asarray(variables["params"]["layer2_0"]["conv1"]["kernel"])  # (T, H, W, I, O)
    got = trunk.layer2[0].conv1.weight.detach().numpy()  # (O, I, T, H, W)
    assert kernel.shape == (3, 3, 3, 16, 32) and got.shape == (32, 16, 3, 3, 3)
    np.testing.assert_array_equal(got, np.transpose(kernel, (4, 3, 0, 1, 2)))
    ds = np.asarray(variables["params"]["layer2_0"]["downsample_conv"]["kernel"])
    np.testing.assert_array_equal(trunk.layer2[0].downsample[0].weight.detach().numpy(),
                                  np.transpose(ds, (4, 3, 0, 1, 2)))


@pytest.mark.parametrize("train", [False, True])
def test_resnet3d_trunk_matches_jax(train):
    x, jmodel, variables, trunk = _trunk_pair(IMG_TRAIN if train else IMG)
    mask = jnp.asarray(MASK)
    if train:
        want, mut = jmodel.apply(variables, jnp.asarray(x), train=True, mask=mask, mutable=["batch_stats"])
    else:
        want, mut = jmodel.apply(variables, jnp.asarray(x), train=False), None
    h = trunk.stem(_to_ncthw(x), train, torch.from_numpy(MASK))
    for i in (1, 2, 3, 4):
        h = trunk.layer(i, h, train, torch.from_numpy(MASK))
    assert h.shape[:2] == (B, 128) and h.is_contiguous(memory_format=torch.channels_last_3d)
    got = trunk.head(h)
    _close(got.detach().numpy(), want, "logits")
    if train:
        after = state_dict_from_jax(variables["params"], mut["batch_stats"])
        for key, value in trunk.state_dict().items():
            if key.endswith(("running_mean", "running_var")):
                _close(value.numpy(), after[key].numpy(), key)


def _model_pair(seed=3, img=IMG, **jax_kwargs):
    """The JAX model and the port's on the same weights, BatchNorm
    statistics and (non-trivial) MMTM buffers."""
    x = _clips(seed, img=img)
    jmodel = JaxMMTM3DCNN(nclasses=NC, num_towers=M, width_multiplier=WIDTH, **jax_kwargs)
    variables = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x), train=False)
    rng = np.random.default_rng(seed)
    variables = dict(variables)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda v: jnp.asarray(rng.uniform(0.5, 1.5, v.shape).astype(np.float32)), variables["batch_stats"])
    variables["mmtm"] = {
        name: {**{k: jnp.asarray(rng.uniform(0.2, 0.8, v.shape).astype(np.float32)) for k, v in buffers.items()},
               "step": jnp.asarray(3.0)}
        for name, buffers in variables["mmtm"].items()
    }
    port = MMTM3DCNN(nclasses=NC, width_multiplier=WIDTH).to(memory_format=torch.channels_last_3d)
    missing, unexpected = port.load_state_dict(
        state_dict_from_jax(variables["params"], variables["batch_stats"], variables["mmtm"]), strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    return x, jmodel, variables, port


def _compare_outputs(got, want):
    (t_blend, t_logits, _, _), (j_blend, j_logits, _, _) = got, want
    _close(t_blend.detach().numpy(), j_blend, "blend")
    for i, (t, j) in enumerate(zip(t_logits, j_logits)):
        _close(t.detach().numpy(), j, f"logits {i}")


def _compare_state(port, jvars, mut):
    after = state_dict_from_jax(jvars["params"], mut.get("batch_stats", jvars["batch_stats"]), mut["mmtm"])
    state = port.state_dict()
    for key, want in after.items():
        _close(state[key].numpy(), want.numpy(), key)


def test_mmtm3dcnn_eval_matches_jax():
    x, jmodel, variables, port = _model_pair()
    want, mut = jmodel.apply(variables, jnp.asarray(x), train=False, valid_mask=jnp.asarray(MASK), mutable=["mmtm"])
    with torch.no_grad():
        got = port(torch.from_numpy(x), train=False, valid_mask=torch.from_numpy(MASK))
    _compare_outputs(got, want)
    _compare_state(port, variables, mut)
    # a list of per-modality clips is the same input
    with torch.no_grad():
        again = port([torch.from_numpy(x[:, i]) for i in range(M)], valid_mask=torch.from_numpy(MASK), mmtm_state={})
    torch.testing.assert_close(again[0], got[0])


@pytest.mark.parametrize("caring", [0, 1, 2])
def test_mmtm3dcnn_curated_train_forward_matches_jax(caring):
    """Train mode, curating modality ``caring``: its gates become the
    post-update running average (no bug_compat at N=3)."""
    x, jmodel, variables, port = _model_pair(seed=5 + caring, img=IMG_TRAIN)
    want, mut = jmodel.apply(variables, jnp.asarray(x), jnp.asarray(True), jnp.asarray(caring, jnp.int32),
                             train=True, valid_mask=jnp.asarray(MASK), mutable=["batch_stats", "mmtm"])
    got = port(torch.from_numpy(x), torch.tensor(True), torch.tensor(caring, dtype=torch.int32), train=True,
               valid_mask=torch.from_numpy(MASK))
    _compare_outputs(got, want)
    _compare_state(port, variables, mut)
    assert not port.mmtm2.bug_compat and float(port.mmtm2.step) == 4.0


def test_mmtm3dcnn_flow_off_matches_jax():
    """The cross-modal flow cut: every modality sees the others' dataset
    averages (4 slots: none, then mmtm2..mmtm4 with one (C,) map each)."""
    x, jmodel, variables, port = _model_pair(seed=9, saving_mmtm_squeeze_array=True)
    rng = np.random.default_rng(10)
    maps = [None] + [[rng.uniform(0.0, 1.0, int(c * WIDTH)).astype(np.float32) for _ in range(M)]
                     for c in (128, 256, 512)]
    want, mut = jmodel.apply(variables, jnp.asarray(x), train=False, valid_mask=jnp.asarray(MASK), mmtm_off=True,
                             average_squeezemaps=[None if s is None else [jnp.asarray(v) for v in s] for s in maps],
                             mutable=["mmtm"])
    port.saving_mmtm_squeeze_array = True
    with torch.no_grad():
        got = port(torch.from_numpy(x), valid_mask=torch.from_numpy(MASK), mmtm_off=True,
                   average_squeezemaps=[None if s is None else [torch.from_numpy(v) for v in s] for s in maps])
    _compare_outputs(got, want)
    _compare_state(port, variables, mut)
    for t_slot, j_slot in zip(got[3], want[3]):  # the recorded squeeze maps, [MMTM][modality]
        assert len(t_slot) == M
        for t, j in zip(t_slot, j_slot):
            _close(t.numpy(), j, "squeeze map")


# ---- checkpoints across the packages ---------------------------------------------------------


def _paths(tree, prefix=()):
    if hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, np.shape(tree)


def test_port_3d_checkpoint_loads_in_the_jax_package(tmp_path):
    port = init_model(MMTM3DCNN(nclasses=NC, width_multiplier=WIDTH), 11, "cpu")
    path = str(tmp_path / "model.pt")
    save_weights(port, path)
    params, batch_stats, extras = load_pretrained(path)
    assert extras is None
    x = _clips(12, batch=2)
    variables = JaxMMTM3DCNN(nclasses=NC, num_towers=M, width_multiplier=WIDTH).init(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    assert dict(_paths(params)) == dict(_paths(variables["params"]))  # every parameter, no other
    assert dict(_paths(batch_stats)) == dict(_paths(variables["batch_stats"]))
    back = state_dict_from_jax(params, batch_stats)
    state = port.state_dict()
    for key, value in back.items():
        assert torch.equal(value, state[key]), key


def test_jax_3d_checkpoint_loads_in_the_port(tmp_path):
    jmodel = JaxMMTM3DCNN(nclasses=NC, num_towers=M, width_multiplier=WIDTH)
    state = create_train_state(jmodel, None, jax.random.PRNGKey(4), jnp.zeros((2, M, T, IMG, IMG, 3)),
                               num_modalities=M)
    path = str(tmp_path / "model.pt")
    jax_save_weights(state, path)
    port = init_model(MMTM3DCNN(nclasses=NC, width_multiplier=WIDTH), 0, "cpu")
    file_state = torch.load(path, map_location="cpu", weights_only=True)["model"]
    missing, unexpected = port.load_state_dict(file_state, strict=False)
    assert not unexpected
    # what a .pt never holds: the MMTM buffers (in the .jax.pkl sidecar) and num_batches_tracked
    assert all(k.endswith("num_batches_tracked") or ".running_avg_" in k or k.endswith(".step") for k in missing)
    load_weights(port, path)
    want = state_dict_from_jax(state.params, state.batch_stats)
    for key, value in want.items():
        assert torch.equal(port.state_dict()[key], value), key


# ---- data, options and the dispatch -----------------------------------------------------------


def test_synthetic_clips_are_the_jax_packages_files(tmp_path):
    kw = dict(n_train=5, n_test=3, num_modalities=M, frames=T, image_size=IMG, nclasses=6, seed=3)
    jax_make_synthetic(str(tmp_path / "jax"), **kw)
    make_synthetic_nvgesture(str(tmp_path / "port"), **kw)
    cmp = filecmp.dircmp(tmp_path / "jax", tmp_path / "port")
    assert not cmp.left_only and not cmp.right_only and not cmp.diff_files
    for split in ("train", "test"):
        names = sorted(os.listdir(tmp_path / "jax" / split))
        assert len(names) == kw[f"n_{split}"]
        match, mismatch, errors = filecmp.cmpfiles(tmp_path / "jax" / split, tmp_path / "port" / split, names,
                                                   shallow=False)
        assert match == names and not mismatch and not errors
    assert filecmp.cmp(tmp_path / "jax" / "metadata.json", tmp_path / "port" / "metadata.json", shallow=False)


@pytest.mark.parametrize("scope, build, shape", [
    ("MMTM_MVCNN", build_model_from_config, (4, 2, 32, 32, 3)),
    ("MMTM_3DCNN", build_3dcnn_from_config, (4, M, T, IMG_TRAIN, IMG_TRAIN, 3)),
])
def test_remat_builds_and_steps_as_without(scope, build, shape):
    """``<scope>.remat = True`` builds every tower with per-block remat; one
    train step equals the step without remat on the same weights (the
    recompute leaves the BatchNorm statistics alone)."""
    port_cfg.parse_config(f"{scope}.nclasses = {NC}\n{scope}.width_multiplier = {WIDTH}" if scope == "MMTM_3DCNN"
                          else f"{scope}.nclasses = {NC}")
    plain = init_model(build(), 0, "cpu")
    port_cfg.parse_config(f"{scope}.remat = True")
    remat = init_model(build(), 1, "cpu")
    assert all(t.remat for t in remat.towers) and not any(t.remat for t in plain.towers)
    remat.load_state_dict(plain.state_dict())
    rng = np.random.default_rng(4)
    batch = {"images": torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)),
             "labels": torch.from_numpy(rng.integers(0, NC, shape[0]).astype(np.int32)), "mask": torch.from_numpy(MASK)}
    flips = torch.from_numpy(rng.random(flip_shape(shape)) < 0.5)
    for model in (plain, remat):
        trainer = Trainer(model, make_optimizer(model.parameters(), lr=0.05), nummodalities=model.num_towers,
                          device="cpu")
        trainer.train_batch(batch, flips, torch.tensor(True))
    want = plain.state_dict()
    for key, value in remat.state_dict().items():
        np.testing.assert_allclose(value.double().numpy(), want[key].double().numpy(), rtol=1e-6, atol=1e-9, err_msg=key)


def test_the_entry_builds_the_3d_family(tmp_path):
    """``model='MMTM_3DCNN'`` builds the family from its own gin scope
    (``bug_compat`` False whatever ``MMTM_mitigate`` says, no kernel path)
    with the clip loaders, in channels-last-3d memory on its device."""
    root = make_synthetic_nvgesture(str(tmp_path / "data"), n_train=5, n_test=2, nclasses=NC)
    port_cfg.parse_config(f"""
        MMTM_3DCNN.nclasses = {NC}
        MMTM_3DCNN.width_multiplier = {WIDTH}
        MMTM_3DCNN.modality_names = ['rgb', 'depth', 'flow']
        MMTM_3DCNN.compute_dtype = 'bfloat16'
        MMTM_mitigate.use_pallas = True
        MMTM_mitigate.bug_compat = True
        get_nvgesturedata.root_dir = '{root}'
        get_nvgesturedata.valid_size = 0.4
    """)
    model, (train, valid, test) = build_model_and_loaders("MMTM_3DCNN", 2, "cpu")
    model = init_model(model, 1, "cpu")
    assert isinstance(model, MMTM3DCNN) and model.dtype == torch.bfloat16 and model.modality_names == NAMES
    assert all(not m.bug_compat and not m.use_pallas for m in model.mmtms.values())
    assert model.net_view_2.conv1.weight.is_contiguous(memory_format=torch.channels_last_3d)
    assert (train.num_samples, valid.num_samples, test.num_samples) == (3, 2, 2)
    batch = next(iter(train))
    assert batch["images"].shape == (2, M, T, IMG, IMG, 3) and batch["images"].dtype == torch.uint8
    with pytest.raises(ValueError, match="MMTM_3DCNX"):
        build_model_and_loaders("MMTM_3DCNX", 2, "cpu")
