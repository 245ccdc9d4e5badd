"""llava-next-mistral-7b — VLM: mistral-7b text backbone + patch stub.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.
The anyres vision tower is a stub: the caller supplies 576 precomputed
patch embeddings (``batch["patch_embeds"]``, [B, 576, d_model]) that
``TransformerLM.prefill`` prepends to the text sequence.
"""
from repro_torch.models.config import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    vlm=VLMConfig(num_patches=576),
    rope_theta=1000000.0,
    dtype="bfloat16",
)

REDUCED = ModelConfig(
    name="llava-next-mistral-7b-reduced",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    vlm=VLMConfig(num_patches=8),
    dtype="float32",
)
