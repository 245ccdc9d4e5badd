"""Model / run configuration schema (the JAX package's, field by field).

One :class:`ModelConfig` describes any of the architecture families (the
same fields as the JAX package, so configs compare equal);
:class:`ParallelConfig` carries the run knobs and resolves the
:class:`~repro_torch.core.registry.ExecutionPolicy` once, against this
package's target dialect (Hopper).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # tokens are routed within fixed-size groups (GShard-style) so the
    # dispatch einsum stays rectangular under SPMD
    group_size: int = 4096
    moe_every_n: int = 1          # 1 => every block is MoE
    shared_experts: int = 0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128          # N
    head_dim: int = 64            # P
    expand: int = 2               # d_inner = expand * d_model
    n_groups: int = 1             # B/C groups (G)
    conv_width: int = 4
    chunk_size: int = 256         # SSD chunk length (Q)
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    encoder_layers: int = 6
    num_frames: int = 1500        # stub audio frontend output length


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    num_patches: int = 576        # stub anyres vision frontend output length


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    attn_every: int = 6           # shared attention block period (zamba2)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int                # 0 for attention-free
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    act: str = "silu"             # silu (swiglu) | gelu (plain mlp)
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    pos_emb: str = "rope"         # rope | learned | sinusoidal | none
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    hybrid: Optional[HybridConfig] = None
    max_seq_len: int = 131072
    dtype: str = "bfloat16"       # activations/weights compute dtype
    # sub-quadratic attention available? (long_500k eligibility)
    subquadratic: bool = False

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    def param_count(self) -> int:
        """Approximate parameter count N (the JAX package's arithmetic)."""
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        total = v * d                      # embed
        if not self.tie_embeddings:
            total += v * d                 # lm head
        per_layer_attn = d * (self.num_heads * hd) \
            + d * hd * self.num_kv_heads * 2 \
            + (self.num_heads * hd) * d if self.num_heads else 0
        if self.act == "silu":
            per_layer_mlp = 3 * d * self.d_ff
        else:
            per_layer_mlp = 2 * d * self.d_ff
        if self.family in ("ssm", "hybrid"):
            cfg = self.ssm
            d_in = cfg.expand * d
            conv_dim = d_in + 2 * cfg.n_groups * cfg.state_dim
            nh = d_in // cfg.head_dim
            per_ssm = (d * (2 * d_in + 2 * cfg.n_groups * cfg.state_dim + nh)
                       + conv_dim * cfg.conv_width + 3 * nh + d_in
                       + d_in * d)
            total += self.num_layers * per_ssm
            if self.family == "hybrid":
                total += per_layer_attn + per_layer_mlp   # the shared block
            return total
        if self.moe is not None:
            per_layer_mlp = (3 * d * self.d_ff) * self.moe.num_experts \
                + d * self.moe.num_experts  # router
            if self.moe.shared_experts:
                per_layer_mlp += 3 * d * self.d_ff * self.moe.shared_experts
        total += self.num_layers * (per_layer_attn + per_layer_mlp)
        if self.family == "encdec":
            # encoder blocks + decoder cross-attention
            total += self.encdec.encoder_layers * (per_layer_attn
                                                   + per_layer_mlp)
            total += self.num_layers * per_layer_attn
        return total

    def active_param_count(self) -> int:
        """Active parameters a token (MoE: the top_k and shared experts)."""
        if self.moe is None:
            return self.param_count()
        expert = self.num_layers * 3 * self.d_model * self.d_ff
        return (self.param_count() - expert * self.moe.num_experts
                + expert * (self.moe.top_k + self.moe.shared_experts))


@dataclasses.dataclass(frozen=True)
class ParamLayout:
    """Init-time parameter layout: fusion legality decided at rest.

    The fused lowerings (kernels/fused.py) consume *concatenated* weights:
    ``wqkv = [wq|wk|wv]`` for the norm->q/k/v prologue and ``wig = [wi|wg]``
    for the norm->swiglu pair.  Concatenating per call would cost a
    weight-sized copy per decode tick, so a fusing policy persists the
    concatenated layout at init and the hot loop only takes views.  Every
    consumer reads either layout through the accessors in
    ``models/common.py``.
    """

    attn_qkv: bool = False
    mlp_swiglu: bool = False

    @classmethod
    def plan(cls, cfg: "ModelConfig", policy) -> "ParamLayout":
        """The one place the layout is decided: a fusing policy gets the
        concatenated layout wherever a fused lowering can consume it
        (rmsnorm prologues only)."""
        if not policy.fuses() or cfg.norm != "rmsnorm":
            return cls()
        return cls(attn_qkv=cfg.num_heads > 0,
                   mlp_swiglu=cfg.act == "silu")


#: the per-matrix layout
LEGACY_LAYOUT = ParamLayout()


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Run knobs: the JAX package's fields, with its defaults."""

    # how the model maps onto a mesh (parallel/sharding.py): params and
    # optimizer state sharded over "data" (FSDP), saved residuals
    # seq-sharded over "model", and the decode cache's layout, one of
    # batch_heads (kv heads over "model"), batch_seq (cache seq over
    # "model", for kv heads that do not divide it) and seq_all (cache seq
    # over ("data", "model"), one long sequence)
    fsdp: bool = True
    seq_shard_acts: bool = True
    cache_layout: str = "batch_heads"
    # training: microbatch accumulation steps, what the backward recomputes
    # ("full": each layer's activations; "dots": all but its projections'
    # products; "none": nothing; only under grad mode), and the gradient
    # compression (none | bf16 | int8_ef, train/optim.py)
    grad_accum: int = 1
    remat: str = "full"
    grad_compression: str = "none"
    # the plain attention's query and key chunks
    # (models/attention.py::chunked_attention)
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 1024
    # fold the causal triangle: each query chunk visits only the key
    # chunks at or before its diagonal
    causal_folding: bool = False

    # constrain K/V to the kv-head axis before the group repeat (the
    # baseline); False leaves them in the producer's layout
    constrain_kv_pre_repeat: bool = True
    # constrain the attention and MLP outputs to the seq-sharded residual
    # layout before the residual add (a reduce-scatter, not an all-reduce)
    rs_outputs: bool = False

    # int8 KV cache: int8 values with one f32 scale per (token, head)
    kv_cache_int8: bool = False
    # route attention through the hand-written attention kernels
    # (kernels/fused.py) instead of the plain PyTorch attention
    use_pallas_attn: bool = False
    # lowering policy: an IsaMode value, "auto", or None for the default
    # split (library norms, native kernel-routed hot spots)
    isa_mode: Optional[str] = None
    isa_dialect: Optional[str] = None   # defaults to TARGET (Hopper)
    # fused-epilogue gate: True forces the fused lowerings, False the
    # unfused sequence, None fuses exactly when the policy mode is "auto"
    fuse_epilogues: Optional[bool] = None
    # weight precision: "int8" retargets the fused ops onto their int8
    # twins (over common.quantize_params' tree)
    weight_precision: Optional[str] = None

    def execution_policy(self):
        """Resolve this config's ExecutionPolicy: the one place mode
        strings are decided; call sites only thread the result."""
        from repro_torch.core.dialect import TARGET
        from repro_torch.core.registry import ExecutionPolicy
        dialect = self.isa_dialect or TARGET.name
        if self.isa_mode is not None:
            return ExecutionPolicy(mode=self.isa_mode, dialect=dialect,
                                   kernel_mode=self.isa_mode,
                                   fuse=self.fuse_epilogues,
                                   precision=self.weight_precision)
        # native lowerings are pinned to TARGET; under a foreign dialect
        # the kernel path asks for "auto" instead of an unlowerable kernel
        kernel_mode = "native" if dialect == TARGET.name else "auto"
        return ExecutionPolicy(mode="library", dialect=dialect,
                               kernel_mode=kernel_mode,
                               fuse=self.fuse_epilogues,
                               precision=self.weight_precision)
