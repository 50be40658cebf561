"""Serving traffic, one client in a closed loop: each request is ``batch``
samples of the configuration's test split, in a seeded order, scored the
way the program's ``predict_`` entry scores a split: BatchNorm folded into
the convolutions once at set-up (``engine/fold_bn.py``), then ``Trainer.predict``
over a ``BatchPipeline`` of the request's rows, which collates them on the
host and copies them to the device.

* Set-up: the weights from the seed (BatchNorm scales, shifts and
  statistics drawn too), the fold, the host corpus, ``warmup_requests``
  requests.
* Window: requests one after the other until ``--seconds`` have passed.
  A request's latency runs from the call until its probabilities are numpy
  on the host; ``serve_samples_per_s`` is every sample of every request
  completed over the window, which ends when the last one completes.
* Traced window: ``traced_requests`` requests timed on the host clock,
  then as many under the profiler.
* Check: ``checked_requests`` of the window's requests, drawn from the
  seed, scored again by the reference on the unfolded weights; compared:
  the rows answered, the per-modality logits and the probabilities.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import inputs
from portbench.bench import RunRecord
from portbench.reference import serve as reference_serve
from portbench.spans import Spans
from portbench.trace import run_traced


class Session:
    def __init__(self, cell, seed, device):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.config, self.traffic, self.family = cell.config, cell.traffic, cell.family
        self.arch = self.family.arch(self.config)
        self.attempted = self.failed = 0
        self.answers = []  # (request rows, the program's output)
        self.latencies = []

    def setup(self):
        from greedy_multimodal_learning_tpu_torch.engine.fold_bn import fold_batchnorm
        from greedy_multimodal_learning_tpu_torch.engine.framework import Trainer

        cfg, tr = self.config, self.traffic
        self.model = self.family.program_model(cfg, self.device)
        self.model.load_state_dict(inputs.weights(self.arch, self.seed, self.device, serving=True))
        self.model.eval()
        self.trainer = Trainer(self.model, nummodalities=self.arch.towers, device=self.device)
        self.model.load_state_dict(fold_batchnorm(self.model.state_dict()))
        n = cfg["test_samples"]
        self.images, self.labels = inputs.corpus(self.family.sample_shape(cfg), n, cfg["classes"], self.seed,
                                                 inputs.TEST_CORPUS, self.device)
        self.dataset = inputs.ArrayDataset(self.images, self.labels)
        self.requests = inputs.request_indices(n, tr["batch"], self.seed)
        for _ in range(tr["warmup_requests"]):
            self._request()

    def _request(self):
        from greedy_multimodal_learning_tpu_torch.data.pipeline import BatchPipeline

        rows = next(self.requests)
        return rows, self.trainer.predict(BatchPipeline(self.dataset, rows, self.traffic["batch"], shuffle=False))

    def _serve(self, stop):
        """Requests until ``stop(requests sent, seconds since the first)``;
        returns (completed requests, seconds)."""
        t0 = time.perf_counter()
        done = tried = 0
        while not stop(tried, time.perf_counter() - t0):
            began = time.perf_counter()
            tried += 1
            self.attempted += 1
            try:
                rows, out = self._request()
            except RuntimeError:
                self.failed += 1
                continue
            self.latencies.append(time.perf_counter() - began)
            self.answers.append((rows, out))
            done += 1
        return done, time.perf_counter() - t0

    def window(self, seconds):
        done, elapsed = self._serve(lambda n, t: t >= seconds)
        lat = np.array(self.latencies) * 1e3
        print(f"requests {done}, p95 {np.percentile(lat, 95)} ms, median {np.median(lat)} ms")
        return {"serve_samples_per_s": done * self.traffic["batch"] / elapsed,
                "serve_request_ms_p95": float(np.percentile(lat, 95))}

    def traced_window(self):
        spans = Spans()
        spans.wrap_method(self.trainer, "predict", "portbench.request")
        want = self.traffic["traced_requests"]
        _, untraced = self._serve(lambda n, t: n >= want)
        (done, _), tr = run_traced(lambda: self._serve(lambda n, t: n >= want))
        return RunRecord(self.cell, tr, spans=dict(spans.seconds), units=done, samples=done * self.traffic["batch"],
                         untraced_s=untraced)

    def check(self):
        self.trainer = self.model = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        state = inputs.weights(self.arch, self.seed, self.device, serving=True)
        rng = np.random.default_rng([self.seed, inputs.CHECK_SAMPLE])
        k = min(self.traffic["checked_requests"], len(self.answers))
        picked = sorted(rng.choice(len(self.answers), k, replace=False)) if k else []
        missing, logit_gap, prob_gap = 0, 0.0, 0.0
        for i in picked:
            rows, out = self.answers[i]
            logits, probs = reference_serve.score(self.arch, state, torch.from_numpy(self.images[rows]).to(self.device))
            if len(out["indices"]) != len(rows) or not np.array_equal(out["indices"], rows):
                missing += len(rows)
                continue
            for mine, ref in zip(out["logits"], logits):
                ref = ref.cpu().numpy()
                logit_gap = max(logit_gap, float(np.abs(mine - ref).max() / max(np.abs(ref).max(), 1e-30)))
            prob_gap = max(prob_gap, float(np.abs(out["probabilities"] - probs.cpu().numpy()).max()))
        return {"rows_missing": float(missing + (len(self.answers) == 0)), "logit_gap": logit_gap,
                "prob_gap": prob_gap}
