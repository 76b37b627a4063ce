"""whisper-medium [audio] -- enc-dec, 24L each, d_model=1024 16H (kv=16)
d_ff=4096 vocab=51865.  The conv front end is a stub: the encoder takes
precomputed 1500-frame embeddings (``batch["frames"]``).  Decoder
architectural max context = 448 tokens.  [arXiv:2212.04356; unverified]
(Mirrors repro/configs/whisper_medium.py.)"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=4096, vocab=51865,
    n_enc_layers=24, enc_seq=1500, dec_max=448,
    use_rope=False, learned_pos=448, gated_mlp=False,
    act="gelu", norm="ln",
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="encdec", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=4, d_ff=256, vocab=512,
    n_enc_layers=2, enc_seq=32, dec_max=16,
    use_rope=False, learned_pos=16, gated_mlp=False,
    act="gelu", norm="ln",
)
