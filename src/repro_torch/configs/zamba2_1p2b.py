"""zamba2-1.2b — hybrid Mamba2 backbone + shared attention block.

[arXiv:2411.15242; hf]
38L d_model=2048 32H (kv=32, MHA) d_ff=8192 vocab=32000, ssm_state=64.
One transformer block's weights are shared across periodic applications
(every 6 mamba layers); Zamba2's per-application LoRA deltas are
simplified away, as in the JAX package.
"""
from repro_torch.models.config import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, n_groups=1,
                  conv_width=4, chunk_size=256),
    hybrid=HybridConfig(attn_every=6),
    subquadratic=True,
    dtype="bfloat16",
)

REDUCED = ModelConfig(
    name="zamba2-1.2b-reduced",
    family="hybrid",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, n_groups=1,
                  conv_width=4, chunk_size=16),
    hybrid=HybridConfig(attn_every=2),
    subquadratic=True,
    dtype="float32",
)
