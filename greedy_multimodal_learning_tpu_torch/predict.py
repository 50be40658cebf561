"""Batch-inference (serving) entry point, the port of the repository's
``predict.py``.

    python -m greedy_multimodal_learning_tpu_torch.predict SAVE_PATH CONFIG.gin \\
        "predict_.pretrained_weights_path='RUN/model_best_val.pt'"

Loads a checkpoint, runs the eval forward over the selected split on the
GPU (bind ``predict_.device='cpu'`` for the CPU), and writes
``SAVE_PATH/predictions.csv`` with one row per sample (index, model name,
true class, predicted class, confidence) plus a throughput line to stdout.
A run of the JAX package serves as it is: the checkpoint's ``.jax.pkl``,
when there is one, gives the weights and the MMTM buffers.
``predict_.fold_bn=True`` folds the BatchNorm statistics into the
convolutions before serving (:mod:`.engine.fold_bn`).
"""

from __future__ import annotations

import logging
import os
import time

from . import config as cfg
from .bootstrap import build_model_and_loaders, init_model, resolve_device, select_split
from .engine.fold_bn import fold_batchnorm
from .engine.framework import Trainer
from .utils import configure_logger, gin_wrap

logger = logging.getLogger(__name__)


@cfg.configurable
def predict_(
    save_path,
    target_data_split="test",
    pretrained_weights_path=None,
    batch_size=128,
    seed=777,
    model="MMTM_MVCNN",
    fold_bn=False,
    device="cuda",
):
    """Run inference over a split and write predictions.csv.

    Returns (csv_path, the dict of :meth:`Trainer.predict`)."""
    device = resolve_device(device)
    model, loaders = build_model_and_loaders(model, batch_size, device)
    target = select_split(loaders, target_data_split)
    model = init_model(model, seed, device)

    trainer = Trainer(model, nummodalities=model.num_towers, device=device)
    if pretrained_weights_path:
        trainer.load_weights(pretrained_weights_path)
    if fold_bn:
        model.load_state_dict(fold_batchnorm(model.state_dict()))
        logger.info("Serving with BatchNorm folded into the convolutions")

    t0 = time.time()
    out = trainer.predict(target)
    dt = time.time() - t0
    n = len(out["indices"])

    os.makedirs(save_path, exist_ok=True)
    csv_path = os.path.join(save_path, "predictions.csv")
    ds = target.dataset
    correct = 0
    with open(csv_path, "w") as f:
        f.write("index,model,true_class,predicted_class,confidence\n")
        for row, idx in enumerate(out["indices"]):
            sample_meta = ds.samples[int(idx)]
            true_cls = sample_meta["classname"]
            pred_cls = ds.classnames[int(out["predictions"][row])]
            correct += pred_cls == true_cls
            conf = float(out["probabilities"][row].max())
            f.write(f"{int(idx)},{sample_meta['model']},{true_cls},{pred_cls},{conf:.6f}\n")
    acc = correct / max(n, 1)
    print(f"predict: {n} samples in {dt:.2f}s ({n / max(dt, 1e-9):.1f} samples/s), "
          f"top-1 {100 * acc:.2f}% -> {csv_path}")
    return csv_path, out


if __name__ == "__main__":
    configure_logger("")
    gin_wrap(predict_)
