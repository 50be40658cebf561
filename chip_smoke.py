#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Imports only the port (``greedy_multimodal_learning_tpu_torch``), never jax.
Phases, each of which fails the run (non-zero exit) when it fails:

1. the card's name and power limit; build every CUDA kernel of the serving
   path from the sources in this checkout; TF32 off for the float32 phases;
2. each kernel against its plain PyTorch version on the card at the shapes
   the serving path gives it (the three 224² fusion sites at B=128, plus a
   ragged B=5), float32 and bfloat16, with times from CUDA events;
3. the serving path at full width: ``predict_`` with
   ``configs/training_guided.gin`` + ``MMTM_mitigate.use_pallas=True`` over a
   synthetic 224², 2-view, 40-class split of 200 test samples (one padded
   batch of 128) from a seeded checkpoint in the JAX package's ``.pt``
   layout, in float32 and with the ``configs/tpu_bf16.gin`` mixin; the
   kernel's launch count must show every fusion site of every batch; the
   float32 logits must agree with the eager gating path, and a small input
   must agree with the port's CPU forward;
4. a ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.

Scratch files go to ``smoke_out/`` in the checkout (git-ignored); the
synthetic split and the checkpoint are removed at exit.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from greedy_multimodal_learning_tpu_torch import config as cfg
from greedy_multimodal_learning_tpu_torch.bootstrap import init_model
from greedy_multimodal_learning_tpu_torch.data.synthetic import make_synthetic_modelnet
from greedy_multimodal_learning_tpu_torch.models import MMTMMVCNN
from greedy_multimodal_learning_tpu_torch.ops import build as kernel_build
from greedy_multimodal_learning_tpu_torch.ops.mmtm_gating import mmtm_gating, mmtm_gating_plain
from greedy_multimodal_learning_tpu_torch.predict import predict_

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "smoke_out")
DATA = os.path.join(WORK, "data")  # synthetic split and checkpoint: removed at exit
CKPT = os.path.join(WORK, "seeded.pt")

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and the
# arithmetic rate for each input type (bf16 at the tensor-core rate, float32
# outside the tensor cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

SITES = {"mmtm2": (784, 128), "mmtm3": (196, 256), "mmtm4": (49, 512)}  # (S, C) at 224²
BATCH = 128
N_TEST = 200
TOL = {
    # f32: same arithmetic, other summation order
    torch.float32: {"out": (1e-5, 1e-5), "sq": (1e-5, 1e-5), "g": (1e-5, 1e-5)},
    # bf16: sq from the same bf16 inputs (f32 sums); g may see joint/e round
    # across a bf16 boundary; out within one bf16 ulp (2^-7 relative)
    torch.bfloat16: {"out": (8e-3, 0.0), "sq": (1e-5, 1e-6), "g": (0.0, 2e-3)},
}
EAGER_LOGIT_ATOL = 1e-4
CPU_LOGIT_TOL = (1e-4, 1e-4)  # (rtol, atol): cuDNN without TF32 vs the CPU's f32 convolutions


def log(msg):
    print(msg, flush=True)


def smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


# ---- phase 2 helpers -----------------------------------------------------------


def gating_inputs(B, S, C, dtype, seed):
    """Seeded features and nn.Linear-initialized MMTM weights on the card
    (D = C at ratio 4)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    D = C

    def uni(shape, fan_in):
        bound = fan_in ** -0.5
        return (torch.rand(shape, generator=g, device="cuda") * 2 - 1) * bound

    f0 = torch.randn((B, S, C), generator=g, device="cuda").relu()
    f1 = torch.randn((B, S, C), generator=g, device="cuda").relu()
    weights = [uni((D, 2 * C), 2 * C), uni((D,), 2 * C), uni((C, D), D), uni((C,), D), uni((C, D), D), uni((C,), D)]
    return [t.to(dtype).contiguous() for t in [f0, f1] + weights]


def eager_gating(f0, f1, wsq, bsq, w0, b0, w1, b1):
    """The eager gating path of models/mmtm.py (biases added in the compute
    dtype), on (B, S, C) maps: the yardstick for the fused kernel, since no
    single PyTorch call computes the fused gating."""
    sq = [f0.mean(dim=1, dtype=torch.float32), f1.mean(dim=1, dtype=torch.float32)]
    e = torch.relu(torch.nn.functional.linear(torch.cat(sq, 1).to(f0.dtype), wsq) + bsq)
    g0 = torch.sigmoid((torch.nn.functional.linear(e, w0) + b0).float())
    g1 = torch.sigmoid((torch.nn.functional.linear(e, w1) + b1).float())
    return f0 * g0[:, None, :].to(f0.dtype), f1 * g1[:, None, :].to(f1.dtype), sq[0], sq[1], g0, g1


def time_ms(fn, args, iters=20, warmup=3):
    """Median device time of one call, L2 flushed before each (a fusion
    site's input arrives from the previous layer, not from a warm L2)."""
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn(*args)
    times = []
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(B, S, C, dtype):
    """Least time for one fused gating call: each input read once and each
    output written once over HBM bandwidth, or its arithmetic over the peak
    rate for the input type, whichever is larger."""
    D = C
    item = torch.tensor([], dtype=dtype).element_size()
    maps = B * S * C * item
    weights = (2 * C * D + D + 2 * (D * C + C)) * item
    rows = 4 * B * C * 4  # sq0, sq1, g0, g1 in f32
    nbytes = 4 * maps + weights + rows
    flops = 2 * B * (2 * C * D + 2 * D * C) + 2 * 2 * B * S * C  # products + squeeze + scale
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_close(name, got, want, rtol, atol):
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        err = (got - want).abs()
        worst = int(torch.argmax(err - atol - rtol * want.abs()))
        raise AssertionError(
            f"{name}: max |diff| {err.max().item():.3e} beyond rtol={rtol} atol={atol} "
            f"(worst at flat {worst}: got {got.flatten()[worst].item()!r} want {want.flatten()[worst].item()!r})"
        )
    return float((got - want).abs().max())


def kernel_phase():
    """Kernel vs plain at the serving path's shapes; returns per-dtype timing."""
    cases = [(name, BATCH, S, C) for name, (S, C) in SITES.items()] + [("mmtm3_ragged", 5, 196, 256)]
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[dtype]
        per_site, max_err = {}, 0.0
        for seed, (name, B, S, C) in enumerate(cases):
            args = gating_inputs(B, S, C, dtype, seed)
            got = mmtm_gating(*args)
            torch.cuda.synchronize()
            want = mmtm_gating_plain(*args)
            for label, a, b in zip(("out0", "out1", "sq0", "sq1", "g0", "g1"), got, want):
                rtol, atol = tol[label[:-1]]
                max_err = max(max_err, check_close(f"{name} {dtype} {label}", a, b, rtol, atol))
            if B != BATCH:
                continue
            bms, bby = bound_ms(B, S, C, dtype)
            per_site[name] = {
                "shape": [B, S, C],
                "ms": time_ms(mmtm_gating, args),
                "plain_ms": time_ms(mmtm_gating_plain, args),
                "eager_ms": time_ms(eager_gating, args),
                "bound_ms": bms,
                "bound_by": bby,
            }
            log(f"[kernel] {name} {str(dtype)[6:]} B={B} S={S} C={C}: " + json.dumps(per_site[name]))
        totals = {k: sum(site[k] for site in per_site.values()) for k in ("ms", "plain_ms", "eager_ms", "bound_ms")}
        report[dtype] = {"sites": per_site, "max_abs_err": max_err, **totals}
        log(f"[kernel] {str(dtype)[6:]} per forward (3 sites): " + json.dumps(totals) + f" max_abs_err {max_err:.3e}")
    return report


# ---- phase 3 helpers -------------------------------------------------------------


def seeded_checkpoint(path, seed=0):
    """A seeded-init model with perturbed BatchNorm statistics, saved as the
    JAX package writes ``.pt`` files: {"model": state_dict, "optimizer": {}},
    without num_batches_tracked and MMTM buffers."""
    model = init_model(MMTMMVCNN(nclasses=40, use_pallas=True), seed, "cpu")
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                m.running_var.copy_(0.5 + torch.rand(c, generator=g))
                m.weight.copy_(0.5 + torch.rand(c, generator=g))
                m.bias.copy_(0.1 * torch.randn(c, generator=g))
    sd = {
        k: v.contiguous()
        for k, v in model.state_dict().items()
        if not (k.endswith("num_batches_tracked") or ".running_avg_" in k or k.endswith(".step"))
    }
    torch.save({"model": sd, "optimizer": {}}, path)
    return model


def run_predict(tag, configs, bindings, out_dir):
    """One ``predict_`` run through the gin surface; returns (out dict,
    samples/s as predict_ reports it, kernel launches during the run)."""
    cfg.clear_config()
    cfg.parse_config_files_and_bindings([os.path.join(REPO, c) for c in configs], "\n".join(bindings))
    buf = io.StringIO()
    mmtm_gating.launches = 0
    with contextlib.redirect_stdout(buf):
        csv_path, out = predict_(out_dir)
    torch.cuda.synchronize()
    launches = mmtm_gating.launches
    line = buf.getvalue().strip().splitlines()[-1]
    log(f"[predict {tag}] {line} | kernel launches {launches}")
    rate = float(re.search(r"\(([0-9.]+) samples/s\)", line).group(1))
    with open(csv_path) as f:
        rows = f.read().strip().splitlines()
    if rows[0] != "index,model,true_class,predicted_class,confidence" or len(rows) != N_TEST + 1:
        raise AssertionError(f"{tag}: predictions.csv has {len(rows) - 1} rows, header {rows[0]!r}")
    for v in out["logits"]:
        if v.shape != (N_TEST, 40) or not np.isfinite(v).all():
            raise AssertionError(f"{tag}: logits of shape {v.shape}, finite={np.isfinite(v).all()}")
    return out, rate, launches


def serving_phase():
    t0 = time.time()
    make_synthetic_modelnet(DATA, n_train=8, n_test=N_TEST, num_views=2, image_size=224, nclasses=40, seed=0)
    cpu_model = seeded_checkpoint(CKPT)
    log(f"[serving] synthetic split + checkpoint in {time.time() - t0:.1f}s")

    base = [
        "MMTM_mitigate.use_pallas=True",
        "predict_.batch_size=128",
        f"get_mvdcndata.root_dir='{DATA}'",
        "get_mvdcndata.specific_views=[0, 1]",
        f"predict_.pretrained_weights_path='{CKPT}'",
    ]
    n_batches = -(-N_TEST // BATCH)
    expected = 3 * n_batches * 1  # fusion sites x batches x kernel calls per site
    results = {}
    for tag, configs, extra in (
        ("f32", ["configs/training_guided.gin"], []),
        ("f32_eager", ["configs/training_guided.gin"], ["MMTM_mitigate.use_pallas=False"]),
        ("bf16", ["configs/training_guided.gin", "configs/tpu_bf16.gin"], []),
    ):
        out_dir = os.path.join(WORK, f"predict_{tag}")
        run_predict(tag + " warm-up", configs, base + extra, out_dir)
        out, rate, launches = run_predict(tag, configs, base + extra, out_dir)
        want = 0 if tag.endswith("eager") else expected
        if launches != want:
            raise AssertionError(f"{tag}: {launches} kernel launches, expected {want}")
        results[tag] = {"out": out, "samples_per_s": rate, "launches": launches}

    # kernel path vs eager path, f32: logits within atol; classes equal but for near-ties
    k, e = results["f32"]["out"], results["f32_eager"]["out"]
    logit_err = max(float(np.abs(a - b).max()) for a, b in zip(k["logits"], e["logits"]))
    blend_e = sum(e["logits"]) / 2.0
    top2 = np.sort(blend_e, axis=1)[:, -2:]
    near_tie = (top2[:, 1] - top2[:, 0]) <= 1e-4
    differ = k["predictions"] != e["predictions"]
    log(f"[serving] f32 kernel vs eager: max |logit diff| {logit_err:.3e}, classes differ on "
        f"{int(differ.sum())} rows ({int((differ & near_tie).sum())} near-ties)")
    if logit_err > EAGER_LOGIT_ATOL:
        raise AssertionError(f"kernel vs eager logits differ by {logit_err:.3e} > {EAGER_LOGIT_ATOL}")
    if (differ & ~near_tie).any():
        raise AssertionError(f"kernel vs eager classes differ on non-tied rows {np.flatnonzero(differ & ~near_tie)}")
    b = results["bf16"]["out"]
    agree = float((b["predictions"] == k["predictions"]).mean())
    bf16_err = max(float(np.abs(x - y).max()) for x, y in zip(b["logits"], k["logits"]))
    log(f"[serving] bf16 vs f32: class agreement {agree:.3f}, max |logit diff| {bf16_err:.3e}")

    # the card's forward (kernel path) vs the port's CPU forward (plain path), small input
    cfg.clear_config()
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(3, 2, 64, 64, 3)).astype(np.float32))
    mask = torch.tensor([1.0, 1.0, 0.0])
    with torch.no_grad():
        _, want, _, _ = cpu_model(x, valid_mask=mask, mmtm_state={})
        gpu_model = cpu_model.to("cuda")
        mmtm_gating.launches = 0
        _, got, _, _ = gpu_model(x.cuda(), valid_mask=mask.cuda(), mmtm_state={})
    if mmtm_gating.launches != 3:
        raise AssertionError(f"small-input forward made {mmtm_gating.launches} kernel launches, expected 3")
    cpu_err = max(
        check_close(f"gpu vs cpu logits view {i}", g.cpu(), w, *CPU_LOGIT_TOL) for i, (g, w) in enumerate(zip(got, want))
    )
    log(f"[serving] card (kernel) vs CPU (plain) forward at 64², B=3: max |logit diff| {cpu_err:.3e}")
    return {
        tag: {"samples_per_s": r["samples_per_s"], "launches": r["launches"]} for tag, r in results.items()
    } | {"eager_logit_err": logit_err, "bf16_class_agreement": agree, "cpu_logit_err": cpu_err}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    os.makedirs(WORK, exist_ok=True)
    smi = smi_line()
    log(f"[card] {smi} | torch {torch.__version__} CUDA {torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    t0 = time.time()
    libs = kernel_build.build(["mmtm_gating"])
    log(f"[build] {time.time() - t0:.1f}s: " + ", ".join(str(p.relative_to(REPO)) for p in libs.values()))
    for p in libs.values():
        log_path = p.with_suffix(".so.log")
        if log_path.exists():
            log("[build] ptxas: " + " | ".join(l.strip() for l in log_path.read_text().splitlines() if "Used" in l))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    timing = kernel_phase()
    try:
        serving = serving_phase()
    finally:
        shutil.rmtree(DATA, ignore_errors=True)
        if os.path.exists(CKPT):
            os.remove(CKPT)
    log("[serving] " + json.dumps(serving))

    f32, bf16 = timing[torch.float32], timing[torch.bfloat16]
    kernels = [{
        "name": "mmtm_gating",
        "route": "cuda",
        "source": "greedy_multimodal_learning_tpu_torch/csrc/mmtm_gating.cu",
        "replaces": "greedy_multimodal_learning_tpu/ops/mmtm_pallas.py:47",
        "replaces_kernel": "_gating_kernel",
        "launches": serving["f32"]["launches"],
        "launches_bf16": serving["bf16"]["launches"],
        "max_abs_err": f32["max_abs_err"],
        "max_abs_err_bf16": bf16["max_abs_err"],
        # float32, the configuration's dtype: one forward's three fusion sites at B=128
        "ms": f32["ms"],
        "kernel_ms": f32["ms"],
        "plain_ms": f32["plain_ms"],
        "eager_ms": f32["eager_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": "bytes" if all(s["bound_by"] == "bytes" for s in f32["sites"].values()) else "operations",
        "library_ms": None,
        "bf16": {k: bf16[k] for k in ("ms", "plain_ms", "eager_ms", "bound_ms")},
        "sites": {str(dt)[6:]: t["sites"] for dt, t in timing.items()},
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
