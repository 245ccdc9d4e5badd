"""qwen3-32b — dense with qk_norm, GQA.

[hf:Qwen/Qwen3-8B; hf]
64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936, head_dim=128,
per-head RMS q/k normalization (the qwen3 signature).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
    dtype="bfloat16",
)

REDUCED = ModelConfig(
    name="qwen3-32b-reduced",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    qk_norm=True,
    dtype="float32",
)
