"""Training of the port (PyTorch port of ``repro.train``): the fused train
step and loop, checkpoints in the JAX package's format, and the fault
tolerance around them."""
from .checkpoint import (CheckpointManager, latest_step, restore_pytree,
                         save_pytree)
from .fault_tolerance import (BadStepFilter, FailureInjector, StepTimer,
                              run_with_restarts)
from .train_loop import (TrainConfig, load_state_tree, make_train_step,
                         state_tree, train)

__all__ = ["CheckpointManager", "latest_step", "restore_pytree",
           "save_pytree", "TrainConfig", "train", "make_train_step",
           "state_tree", "load_state_tree", "BadStepFilter",
           "FailureInjector", "StepTimer", "run_with_restarts"]
