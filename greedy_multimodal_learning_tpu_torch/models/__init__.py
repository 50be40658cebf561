from .layers import BatchNorm2d, Conv2d, Linear, init_parameters
from .resnet import BasicBlock, ResNet18Trunk
from .mmtm import MMTM, mmtm_config_kwargs
from .mvcnn import MMTMMVCNN, MODELNET40_CLASSNAMES, build_model_from_config
