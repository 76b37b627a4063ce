"""The parts of :mod:`repro.train` that the port's simulator uses: the
carry checkpoints of :mod:`repro_torch.train.checkpoint`."""

from .checkpoint import (CheckpointHandle, latest_step, read_checkpoint_arrays,
                         restore_checkpoint, save_checkpoint)

__all__ = ["CheckpointHandle", "latest_step", "read_checkpoint_arrays",
           "restore_checkpoint", "save_checkpoint"]
