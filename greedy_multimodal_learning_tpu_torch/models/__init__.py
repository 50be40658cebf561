from .layers import BatchNorm2d, BatchNorm3d, Conv2d, Conv3d, Linear, init_parameters, rematerialize
from .resnet import BasicBlock, ResNet18Trunk
from .resnet3d import BasicBlock3D, ResNet3D18Trunk
from .mmtm import MMTM, mmtm_config_kwargs
from .mvcnn import (
    MMTMMVCNN,
    MODELNET40_CLASSNAMES,
    apply_pretrained_trunks,
    build_model_from_config,
    resolve_pretrained_path,
)
from .mmtm_3dcnn import MMTM3DCNN, build_3dcnn_from_config
