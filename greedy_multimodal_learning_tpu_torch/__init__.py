"""greedy_multimodal_learning_tpu_torch — the PyTorch/CUDA port.

A second package beside the JAX one (``greedy_multimodal_learning_tpu``),
ported one slice at a time for an NVIDIA H100.  Module names mirror the JAX
package's so each module's counterpart is easy to find.  The JAX package is
the reference the port's tests hold it against; the port itself imports
``torch`` and never ``jax`` nor anything of the JAX package.

Ported so far: serving (``predict_``), training with resume under the
guided, random, weakest and adaptive-weakest controllers (``train``) and
the conditional-utilization eval (``eval_``: the recording pass and the
flow-off pass, ``analysis/``), on both model families: the two-tower
ResNet-18 + MMTM model (``models/mvcnn.py``) and the 3-modality r3d-18 +
MMTM model (``models/mmtm_3dcnn.py``, RGB + depth + flow clips from
``data/nvgesture.py``), reading each split from a corpus resident on the
device (``data/pipeline.py``), with the fused MMTM gating forward and
backward as hand-written CUDA kernels (``ops/mmtm_gating.py``, ``csrc/``)
on the two-modality path and the host data helpers of ``csrc/fastio.cc``.

Beside them: checkpoints of the JAX package, its ``.jax.pkl`` sidecar
included, for serving, eval and resume (``engine/checkpoint.py``, read with
no jax); BatchNorm folding for serving and eval (``engine/fold_bn.py``);
K checkpoints in one pass (``eval_sweep``); the model options ``SEonly``,
``shareweight``, ``stem_s2d``, ``remat`` and ``pretraining``; in-process
entry runs (``run_api.run_entry``) and a traced train epoch
(``Trainer.enable_profiling``); data parallelism over ``torch.distributed``
ranks, one process a card (``parallel/``, ``training_loop.data_parallel``,
``evalution_loop.data_parallel``), with tensor parallelism over model
groups beside it (``model_parallel``, ``parallel/tensor.py``).
``orbax_dir`` is not ported and raises.
"""

__version__ = "0.1.0"
