"""rwkv6-7b [ssm] -- Finch: 32L d_model=4096 (attn-free) d_ff=14336
vocab=65536.  Data-dependent decay; O(1)/token decode.
[arXiv:2404.05892; hf]  (Mirrors repro/configs/rwkv6_7b.py.)"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm", n_layers=32, d_model=4096,
    n_heads=64, n_kv_heads=64, d_head=64, d_ff=14336, vocab=65536,
    block_pattern=("rwkv",), use_rope=False, norm="ln",
    subquadratic=True,
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", family="ssm", n_layers=2, d_model=128,
    n_heads=2, n_kv_heads=2, d_head=64, d_ff=256, vocab=512,
    block_pattern=("rwkv",), use_rope=False, norm="ln",
    subquadratic=True,
)
