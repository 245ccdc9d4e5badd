"""llama4-scout-17b-16e — MoE 16 experts top-1 + 1 shared expert.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16e top-1.
'Early fusion' refers to the multimodal frontend, which per the
assignment is out of scope for the LM backbone; we build the text MoE
decoder.  Llama4 routes top-1 with a shared expert, which we keep.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    moe=MoEConfig(num_experts=16, top_k=1, capacity_factor=1.25,
                  group_size=4096, shared_experts=1),
    rope_theta=500000.0,
    dtype="bfloat16",
)

REDUCED = ModelConfig(
    name="llama4-scout-17b-16e-reduced",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab_size=512,
    moe=MoEConfig(num_experts=4, top_k=1, capacity_factor=1.25,
                  group_size=64, shared_experts=1),
    rope_theta=500000.0,
    dtype="float32",
)
