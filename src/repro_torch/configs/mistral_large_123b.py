"""mistral-large-123b — the largest assigned dense config.

[hf:mistralai/Mistral-Large-Instruct-2407; unverified]
88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768, head_dim=128.
The memory-pressure case: FSDP + TP are mandatory for this to fit.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    rope_theta=1000000.0,
    dtype="bfloat16",
)

REDUCED = ModelConfig(
    name="mistral-large-123b-reduced",
    family="dense",
    num_layers=3,
    d_model=96,
    num_heads=6,
    num_kv_heads=2,
    head_dim=16,
    d_ff=192,
    vocab_size=512,
    dtype="float32",
)
