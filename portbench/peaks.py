"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit).  Every run prints
the card's own power limit on standard error and gives it in its result's
``device`` as ``power_limit_w``, beside every share of these."""

POWER_LIMIT_W = 700.0

F32_FLOPS = 67e12  # float32 outside the tensor cores
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
