"""hymba-1.5b [hybrid] — parallel attn+mamba heads [arXiv:2411.13676]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", arch_type="hybrid",
    num_layers=32, d_model=1600, d_ff=5504, vocab_size=32001,
    num_heads=25, num_kv_heads=5, head_dim=64,
    ssm_state=16, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
)

SMOKE = ModelConfig(
    name="hymba-1.5b-smoke", arch_type="hybrid",
    num_layers=2, d_model=256, d_ff=512, vocab_size=512,
    num_heads=4, num_kv_heads=2, head_dim=64,
    ssm_state=16, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
    dtype="float32",
)
