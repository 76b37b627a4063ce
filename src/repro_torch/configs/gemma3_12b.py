"""gemma3-12b [dense] -- 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144.  5:1 local:global attention, 128k context, d_head=256.
long_500k runs: decode cost is dominated by the 1024-window local layers;
the 1-in-6 global layers decode at O(S) (linear) with seq-sharded KV.
[hf:google/gemma-3-1b-pt; unverified]
(Mirrors repro/configs/gemma3_12b.py.)"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense", n_layers=48, d_model=3840,
    n_heads=16, n_kv_heads=8, d_head=256, d_ff=15360, vocab=262144,
    block_pattern=("local", "local", "local", "local", "local", "attn"),
    window=1024, tie_embeddings=True, act="gelu", norm="rms",
    subquadratic=True,
)

SMOKE = ModelConfig(
    name="gemma3-smoke", family="dense", n_layers=6, d_model=96,
    n_heads=4, n_kv_heads=2, d_head=24, d_ff=192, vocab=512,
    block_pattern=("local", "local", "local", "local", "local", "attn"),
    window=16, tie_embeddings=True, act="gelu", norm="rms",
    subquadratic=True,
)
