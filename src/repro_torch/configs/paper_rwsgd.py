"""The paper's own payload: a small decoder LM trained by RW-SGD on a
graph of data-holding nodes (Section I motivating example). Sized so ten
model replicas (walks) fit a single host for the end-to-end example."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paper-rwsgd", arch_type="dense",
    num_layers=4, d_model=256, d_ff=1024, vocab_size=4096,
    num_heads=8, num_kv_heads=4, head_dim=32,
    dtype="float32",
)

SMOKE = ModelConfig(
    name="paper-rwsgd-smoke", arch_type="dense",
    num_layers=2, d_model=128, d_ff=256, vocab_size=512,
    num_heads=4, num_kv_heads=2, head_dim=32,
    dtype="float32",
)
