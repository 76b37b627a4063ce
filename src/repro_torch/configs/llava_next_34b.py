"""llava-next-34b [vlm] -- 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000.  Anyres patch tiling is a stub: 576 precomputed patch
embeddings (``batch["patches"]``) go before the token sequence.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
(Mirrors repro/configs/llava_next_34b.py.)"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm", n_layers=60, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=20480, vocab=64000,
    n_patches=576, act="silu", norm="rms",
)

SMOKE = ModelConfig(
    name="llava-next-smoke", family="vlm", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
    n_patches=4, act="silu", norm="rms",
)
