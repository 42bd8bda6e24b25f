"""granite-8b [dense] — llama-arch, code [arXiv:2405.04324]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b", arch_type="dense",
    num_layers=36, d_model=4096, d_ff=14336, vocab_size=49152,
    num_heads=32, num_kv_heads=8, head_dim=128, rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="granite-8b-smoke", arch_type="dense",
    num_layers=2, d_model=192, d_ff=384, vocab_size=384,
    num_heads=6, num_kv_heads=2, head_dim=32,
    dtype="float32",
)
