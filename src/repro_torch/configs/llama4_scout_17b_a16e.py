"""llama4-scout-17b-a16e [moe] -- 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 + shared expert, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
(Mirrors repro/configs/llama4_scout_17b_a16e.py.)"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=8192, vocab=202048,
    n_experts=16, top_k=1, shared_expert=True, act="silu", norm="rms",
)

SMOKE = ModelConfig(
    name="llama4-scout-smoke", family="moe", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
    n_experts=4, top_k=1, shared_expert=True, act="silu", norm="rms",
    # dropless at smoke scale: capacity drops are a modelled approximation
    # and would mask prefill/decode cache bugs in the consistency tests
    moe_capacity_factor=0.0,
)
