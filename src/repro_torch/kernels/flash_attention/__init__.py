"""Online-softmax flash attention for the LM prefill (CUDA, sm_90a), with
its plain PyTorch version and the materialized-softmax oracle."""

from .ops import flash_attention
from .ref import attention_ref

__all__ = ["attention_ref", "flash_attention"]
