"""The LM optimizer of the port (counterpart of :mod:`repro.optim`): AdamW
with a cosine schedule and the int8 error-feedback compression."""

from .adamw import AdamW, AdamWState, cosine_schedule
from .compress import (compress_int8, compressed_psum, decompress_int8,
                       error_feedback_update)

__all__ = ["AdamW", "AdamWState", "cosine_schedule", "compress_int8",
           "compressed_psum", "decompress_int8", "error_feedback_update"]
