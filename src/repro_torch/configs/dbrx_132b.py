"""dbrx-132b [moe] — 16 experts top-4, fine-grained
[hf:databricks/dbrx-base]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", arch_type="moe",
    num_layers=40, d_model=6144, d_ff=10752, vocab_size=100352,
    num_heads=48, num_kv_heads=8, head_dim=128, rope_theta=500000.0,
    moe_num_experts=16, moe_top_k=4, moe_d_ff=10752,
)

SMOKE = ModelConfig(
    name="dbrx-132b-smoke", arch_type="moe",
    num_layers=2, d_model=256, d_ff=512, vocab_size=512,
    num_heads=8, num_kv_heads=2, head_dim=32,
    moe_num_experts=4, moe_top_k=2, moe_d_ff=128,
    dtype="float32",
)
