"""musicgen-large [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284]. 4 codebooks, 2048 entries each; the EnCodec conv
frontend is a stub (token ids in, per-codebook heads out)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", arch_type="audio",
    num_layers=48, d_model=2048, d_ff=8192, vocab_size=2048,
    num_heads=32, num_kv_heads=32, head_dim=64,
    num_codebooks=4,
)

SMOKE = ModelConfig(
    name="musicgen-large-smoke", arch_type="audio",
    num_layers=2, d_model=256, d_ff=512, vocab_size=128,
    num_heads=8, num_kv_heads=8, head_dim=32,
    num_codebooks=4,
    dtype="float32",
)
