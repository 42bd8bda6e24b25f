"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed
top-6 experts [arXiv:2405.04434]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", arch_type="moe",
    num_layers=60, d_model=5120, d_ff=12288, vocab_size=102400,
    num_heads=128, num_kv_heads=128, head_dim=128,
    moe_num_experts=160, moe_top_k=6, moe_num_shared=2, moe_d_ff=1536,
    use_mla=True, kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
)

SMOKE = ModelConfig(
    name="deepseek-v2-236b-smoke", arch_type="moe",
    num_layers=2, d_model=256, d_ff=512, vocab_size=512,
    num_heads=4, num_kv_heads=4, head_dim=64,
    moe_num_experts=4, moe_top_k=2, moe_num_shared=1, moe_d_ff=128,
    use_mla=True, kv_lora_rank=64, q_lora_rank=96, rope_head_dim=32,
    dtype="float32",
)
