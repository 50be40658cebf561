from .modelnet import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    MultiviewModelNet,
    get_mvdcndata,
    load_view_stack,
    reference_val_split,
)
from .pipeline import BatchPipeline
from .transforms import preprocess
