"""deepseek-67b [dense] — llama-arch [arXiv:2401.02954]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", arch_type="dense",
    num_layers=95, d_model=8192, d_ff=22016, vocab_size=102400,
    num_heads=64, num_kv_heads=8, head_dim=128, rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="deepseek-67b-smoke", arch_type="dense",
    num_layers=2, d_model=256, d_ff=640, vocab_size=512,
    num_heads=8, num_kv_heads=2, head_dim=32,
    dtype="float32",
)
