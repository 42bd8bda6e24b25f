"""mamba2-1.3b [ssm] — SSD (state-space duality) [arXiv:2405.21060].
Attention-free: 48 mamba2 blocks, d_state=128, headdim=64."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", arch_type="ssm",
    num_layers=48, d_model=2048, d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
)

SMOKE = ModelConfig(
    name="mamba2-1.3b-smoke", arch_type="ssm",
    num_layers=2, d_model=256, d_ff=0, vocab_size=512,
    ssm_state=32, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
    dtype="float32",
)
