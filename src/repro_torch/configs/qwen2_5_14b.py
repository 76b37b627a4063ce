"""qwen2.5-14b [dense] -- 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064.  GQA with QKV bias.  (Mirrors repro/configs/qwen2_5_14b.py.)"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=13824, vocab=152064,
    qkv_bias=True, act="silu", norm="rms",
)

SMOKE = ModelConfig(
    name="qwen2.5-smoke", family="dense", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
    qkv_bias=True, act="silu", norm="rms",
)
