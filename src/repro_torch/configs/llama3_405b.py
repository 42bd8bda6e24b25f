"""llama3-405b [dense] — GQA, 128k vocab [arXiv:2407.21783]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", arch_type="dense",
    num_layers=126, d_model=16384, d_ff=53248, vocab_size=128256,
    num_heads=128, num_kv_heads=8, head_dim=128, rope_theta=500000.0,
)

SMOKE = ModelConfig(
    name="llama3-405b-smoke", arch_type="dense",
    num_layers=2, d_model=256, d_ff=512, vocab_size=512,
    num_heads=8, num_kv_heads=2, head_dim=32, rope_theta=500000.0,
    dtype="float32",
)
