from .checkpoint import load_training_state, load_weights, read_jax_sidecar, save_weights, state_dict_from_jax
from .controller import ControllerState, guided_update, init_controller_state, null_update
from .fold_bn import fold_batchnorm
from .framework import Trainer
from .loop import evalution_loop, training_loop
from .sweep import eval_sweep
from .train_state import get_learning_rate, make_optimizer, set_learning_rate
