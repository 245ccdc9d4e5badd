"""whisper-base — encoder-decoder audio backbone, conv frontend stubbed.

[arXiv:2212.04356; unverified]
6L (decoder) d_model=512 8H d_ff=2048 vocab=51865; 6-layer encoder over
1500 stub frame embeddings.  LayerNorm + GELU + learned positions per the
whisper lineage.  The assigned decode shapes stretch the decoder context
far past whisper's real 448; the pos_embed table is sized to cover them.
"""
from repro_torch.models.config import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    encdec=EncDecConfig(encoder_layers=6, num_frames=1500),
    norm="layernorm",
    act="gelu",
    pos_emb="learned",
    max_seq_len=36864,          # covers decode_32k cache + margin
    dtype="bfloat16",
)

REDUCED = ModelConfig(
    name="whisper-base-reduced",
    family="encdec",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    encdec=EncDecConfig(encoder_layers=2, num_frames=16),
    norm="layernorm",
    act="gelu",
    pos_emb="learned",
    max_seq_len=128,
    dtype="float32",
)
