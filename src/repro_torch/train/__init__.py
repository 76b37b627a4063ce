"""The training substrate of the port (counterpart of :mod:`repro.train`):
the train step, checkpoints (which the simulator's supervision also
writes) and fault tolerance."""

from .checkpoint import (CheckpointHandle, latest_step, read_checkpoint_arrays,
                         restore_checkpoint, save_checkpoint)
from .fault import FaultConfig, StragglerDetector, simulate_failures
from .train_step import (ShardedParams, TrainState, init_train_state,
                         make_train_step, shard_train_state,
                         unshard_train_state)

__all__ = ["CheckpointHandle", "FaultConfig", "ShardedParams",
           "StragglerDetector", "TrainState", "init_train_state",
           "latest_step", "make_train_step", "read_checkpoint_arrays",
           "restore_checkpoint", "save_checkpoint", "shard_train_state",
           "simulate_failures", "unshard_train_state"]
