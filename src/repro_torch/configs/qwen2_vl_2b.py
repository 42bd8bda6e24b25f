"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191].
ViT frontend is a stub: input_specs() provides precomputed patch
embeddings; the decoder applies M-RoPE over (t, h, w) streams."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", arch_type="vlm",
    num_layers=28, d_model=1536, d_ff=8960, vocab_size=151936,
    num_heads=12, num_kv_heads=2, head_dim=128, rope_theta=1000000.0,
    mrope=True, mrope_sections=(16, 24, 24), vision_tokens=1024,
)

SMOKE = ModelConfig(
    name="qwen2-vl-2b-smoke", arch_type="vlm",
    num_layers=2, d_model=256, d_ff=512, vocab_size=512,
    num_heads=4, num_kv_heads=2, head_dim=64,
    mrope=True, mrope_sections=(8, 12, 12), vision_tokens=16,
    dtype="float32",
)
