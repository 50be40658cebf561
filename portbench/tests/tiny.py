"""Cells of the benchmark cut to a size the CPU runs in seconds, for the
tests: the same configuration and traffic files, smaller images, corpora
and batches (the 3-D family at a quarter of its widths), and limits for
that size.

At these sizes the deepest maps hold a few positions, so the masked batch
statistics are over few values, and a batch of 4 at learning rate 0.1
diverges (the loss climbs from step to step): float32 rounding grows
through the set-up steps far more than at the published sizes.  The limits
below are set from runs at these sizes (2-D, eight sound seeds: loss gap up
to 8.4e-3, change gap up to 0.21, buffer gap up to 8.6e-3; half of every
batch left out: loss gap 0.24-0.26; the mask ignored: window loss gap
0.14-0.17; a step that leaves the state as it was reads 1 on
``change_gap``)."""

from portbench import bench

LIMITS = {
    "loss_gap": 3e-2, "grad_gap": 1e-2, "change_gap": 0.4, "buffer_gap": 3e-2,
    "decisions_differ": 0.0, "window_loss_gap": 1e-3, "window_grad_gap": 1e-2, "window_buffer_gap": 1e-2,
    "window_decisions_differ": 0.0, "rows_missing": 0.0, "logit_gap": 1e-4, "prob_gap": 1e-5,
}


def cell(name):
    c = bench.find_cell(name)
    cfg = dict(c.config, train_samples=24, test_samples=12)
    if cfg["family"] == "MMTM_MVCNN":
        # 22 samples in batches of 4: the epoch's last step holds 2 and pads 2
        cfg.update(image_size=96, train_samples=22)
    else:
        cfg.update(image_size=32, frames=4, width_multiplier=0.25, train_steps_per_epoch=3)
    c.config = cfg
    c.traffic = dict(c.traffic, batch=4, traced_requests=2, checked_requests=3, warmup_requests=1)
    c.limits = dict(LIMITS)
    return c


def run(name, seed=2 ** 31 + 99, seconds=0.5):
    import time

    return bench.run_cell(cell(name), seed=seed, seconds=seconds, trace=0, device="cpu", t_start=time.time())
