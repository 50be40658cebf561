from .checkpoint import load_weights, state_dict_from_jax
from .framework import Trainer
