"""mistral-nemo-12b — dense, 128k context.

[hf:mistralai/Mistral-Nemo-Base-2407; hf]
40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim=128.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1000000.0,
    max_seq_len=131072,
    dtype="bfloat16",
)

REDUCED = ModelConfig(
    name="mistral-nemo-12b-reduced",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    rope_theta=1000000.0,
    dtype="float32",
)
