"""mamba2-2.7b — attention-free SSM (SSD / state-space duality).

[arXiv:2405.21060]
64L d_model=2560 (attn-free) vocab=50280, ssm_state=128.
d_inner = 2·d_model = 5120, 80 heads of dim 64, 1 B/C group.
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, n_groups=1,
                  conv_width=4, chunk_size=256),
    subquadratic=True,
    tie_embeddings=True,
    dtype="bfloat16",
)

REDUCED = ModelConfig(
    name="mamba2-2.7b-reduced",
    family="ssm",
    num_layers=3,
    d_model=64,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=512,
    ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, n_groups=1,
                  conv_width=4, chunk_size=16),
    subquadratic=True,
    tie_embeddings=True,
    dtype="float32",
)
