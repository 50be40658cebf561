from .utilization import get_mmtm_outputs, get_rescale_weights
