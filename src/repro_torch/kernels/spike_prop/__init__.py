"""Blocked-ELL spike delivery and fused delivery -> LIF (CUDA, sm_90a)."""
