from .modelnet import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    MultiviewModelNet,
    get_mvdcndata,
    load_view_stack,
    reference_val_split,
)
from .nvgesture import MultimodalClipDataset, get_nvgesturedata, make_synthetic_nvgesture
from .pipeline import BatchPipeline
from .transforms import preprocess
