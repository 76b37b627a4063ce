"""recurrentgemma-2b [hybrid] -- 26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000.  RG-LRU + local attention, 2 recurrent : 1 local-attn
pattern.  [arXiv:2402.19427; hf]
(Mirrors repro/configs/recurrentgemma_2b.py.)"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid", n_layers=26, d_model=2560,
    n_heads=10, n_kv_heads=1, d_head=256, d_ff=7680, vocab=256000,
    block_pattern=("rglru", "rglru", "local"), window=2048, d_rnn=2560,
    tie_embeddings=True, act="gelu", norm="rms", subquadratic=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke", family="hybrid", n_layers=5, d_model=96,
    n_heads=4, n_kv_heads=1, d_head=24, d_ff=192, vocab=512,
    block_pattern=("rglru", "rglru", "local"), window=16, d_rnn=96,
    tie_embeddings=True, act="gelu", norm="rms", subquadratic=True,
)
