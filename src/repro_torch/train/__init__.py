"""The training substrate of the port (counterpart of :mod:`repro.train`):
the train step, checkpoints (which the simulator's supervision also
writes) and fault tolerance."""

from .checkpoint import (CheckpointHandle, latest_step, read_checkpoint_arrays,
                         restore_checkpoint, save_checkpoint)
from .fault import FaultConfig, StragglerDetector, simulate_failures
from .train_step import TrainState, init_train_state, make_train_step

__all__ = ["CheckpointHandle", "FaultConfig", "StragglerDetector",
           "TrainState", "init_train_state", "latest_step",
           "make_train_step", "read_checkpoint_arrays",
           "restore_checkpoint", "save_checkpoint", "simulate_failures"]
