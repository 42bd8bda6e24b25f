"""yi-6b [dense] — llama-arch GQA [arXiv:2403.04652]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", arch_type="dense",
    num_layers=32, d_model=4096, d_ff=11008, vocab_size=64000,
    num_heads=32, num_kv_heads=4, head_dim=128, rope_theta=5000000.0,
)

SMOKE = ModelConfig(
    name="yi-6b-smoke", arch_type="dense",
    num_layers=2, d_model=256, d_ff=512, vocab_size=512,
    num_heads=8, num_kv_heads=1, head_dim=32, rope_theta=5000000.0,
    dtype="float32",
)
