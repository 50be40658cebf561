"""Device operations by name, as the profiler reports them.

* the fused gating kernels of the program's ``csrc/mmtm_gating.cu`` and
  ``csrc/mmtm_gating_bwd.cu``;
* cuDNN's convolutions, forward and both gradients, in 2-D and 3-D, by
  whatever algorithm it picks: implicit GEMM, the GEMMs of its FFT and
  1x1 paths (``xmma``), Winograd, the FFTs, the filter flips and its layout transforms.  A
  bare ``cudnn`` is not enough: cuDNN's BatchNorm kernels carry it too,
  and so do the FFT kernels' argument types;
* PyTorch's generic elementwise and reduction kernels;
* host-to-device copies.
"""

GATING_FORWARD = r"\bgating_fwd_kernel\b"
GATING_BACKWARD = r"\b(gating_bwd_map_kernel|weight_grad_kernel)\b"
CONVOLUTION = r"conv|xmma|implicit_gemm|fprop|dgrad|wgrad|winograd|fft\dd_|flip_filter|cudnn::engines_precompiled"
ELEMENTWISE = r"elementwise_kernel|reduce_kernel"
HOST_TO_DEVICE = r"Memcpy HtoD"
