"""grok-1-314b [moe] -- 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2.  [hf:xai-org/grok-1; unverified]
(Mirrors repro/configs/grok1_314b.py.)"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe", n_layers=64, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=32768, vocab=131072,
    n_experts=8, top_k=2, act="gelu", norm="rms", use_rope=True,
)

SMOKE = ModelConfig(
    name="grok-1-314b-smoke", family="moe", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
    n_experts=4, top_k=2, act="gelu", norm="rms", use_rope=True,
    # dropless at smoke scale: capacity drops are a modelled approximation
    # and would mask prefill/decode cache bugs in the consistency tests
    moe_capacity_factor=0.0,
)
