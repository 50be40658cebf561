"""greedy_multimodal_learning_tpu_torch — the PyTorch/CUDA port.

A second package beside the JAX one (``greedy_multimodal_learning_tpu``),
ported one slice at a time for an NVIDIA H100.  Module names mirror the JAX
package's so each module's counterpart is easy to find.  The JAX package is
the reference the port's tests hold it against; the port itself imports
``torch`` and never ``jax`` nor anything of the JAX package.

Slice 1 (this tree) is the serving path: ``predict_`` → ``Trainer.predict``
→ the two-tower ResNet-18 + MMTM model, with the fused MMTM gating forward
as a hand-written CUDA kernel (``ops/mmtm_gating.py``,
``csrc/mmtm_gating.cu``).
"""

__version__ = "0.1.0"
