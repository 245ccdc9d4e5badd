"""granite-moe-3b-a800m — 40 experts, top-8, tiny expert d_ff=512.

[hf:ibm-granite/granite-3.0-3b-a800m-base; hf]
32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155, MoE 40e top-8,
tied embeddings.  The tiny per-expert FFN makes dispatch overhead the
dominant cost: the stress case for the routing path.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    moe=MoEConfig(num_experts=40, top_k=8, capacity_factor=1.25,
                  group_size=4096),
    tie_embeddings=True,
    dtype="bfloat16",
)

REDUCED = ModelConfig(
    name="granite-moe-3b-a800m-reduced",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=32,
    vocab_size=512,
    moe=MoEConfig(num_experts=8, top_k=4, capacity_factor=1.25,
                  group_size=64),
    tie_embeddings=True,
    dtype="float32",
)
