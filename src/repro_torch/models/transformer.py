"""Decoder-only transformer LM: the dense family (granite-8b,
mistral-nemo-12b, mistral-large-123b, qwen3-32b with per-head q/k rmsnorm),
the MoE family (granite-moe-3b-a800m, llama4-scout-17b-16e with its shared
expert) and the VLM backbone (llava-next-mistral-7b: the text decoder over
a prefix of stub patch embeddings, ``batch["patch_embeds"]``, at prefill).

Parameters are a plain dict of tensors with the JAX package's keys and its
stacked ``[L, ...]`` block layout; layers run as a Python loop over layer
views.  Decode updates the KV cache in place (see models/attention.py).

Under the fused policy (``ParallelConfig(fuse_epilogues=True,
use_pallas_attn=True)``) the hot pairs run the hand-written kernels of
``kernels/fused.py``: ln1->wqkv and the final norm->lm_head (or the tied
embedding) through rmsnorm_matmul, ln2->[wi|wg] through rmsnorm_swiglu,
or, where no [wi|wg] pair follows (a router-only MoE), the residual
add->ln2 through add_rmsnorm, causal prefill attention and dense decode
attention (with wo) through flash_attention_matmul, paged decode attention
through paged_attention_matmul.  Under an unfused kernel policy
(``ParallelConfig(use_pallas_attn=True, isa_mode="native")``) every norm
runs the rmsnorm kernel (``kernels/rmsnorm.py``) and prefill attention the
flash_attention kernel (``kernels/attention.py``).  The embedding gather,
RoPE, the cache writes, the MLP down projection, the MoE routing and
expert products and the plain prefill attention
(``models/attention.py::chunked_attention``) are plain PyTorch; so is
qk_norm under the fused policy, whose norm mode is the library row, as in
the JAX package.

The int8 path (``ParallelConfig(weight_precision="int8",
kv_cache_int8=True)`` beside the fused policy, over
:func:`common.quantize_params`): ``wqkv``, ``wo`` and ``wig`` are int8
with f32 ``*_scale`` siblings, and the policy's precision retargets the
three fused ops onto their ``_q8`` kernels; a float weight reaching a q8
op (the head) is quantized there, as in the JAX package.  The int8 KV
cache is written quantized (values int8, one f32 scale per token and
head); the paged kernel reads the int8 pools itself, the dense decode
path dequantizes its cache strip up front, and the unfused forms
dequantize weights and pools up front.

On a mesh (``ctx``, a :class:`~repro_torch.parallel.sharding.ShardCtx`)
the activations are moved to the layouts the JAX package constrains them
to, at its sites (q, k and v after the projection, the MLP's hidden
activation, the MoE's groups and expert buffers, the residual after each
block, the embedding and the logits); with ``ctx`` None, or on plain
tensors, :func:`~repro_torch.parallel.sharding.shard` is the identity.
:meth:`TransformerLM.param_specs` and :meth:`TransformerLM.cache_specs`
name every leaf's logical axes without allocating a tensor.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.registry import ExecutionPolicy
from repro_torch.models import common, mlp
from repro_torch.models.attention import (chunked_attention,
                                          decode_attention, dequantize_kv,
                                          paged_decode_attention, quantize_kv,
                                          update_cache, update_cache_int8,
                                          update_paged_cache,
                                          update_paged_cache_int8)
from repro_torch.models.config import (LEGACY_LAYOUT, ModelConfig,
                                       ParallelConfig, ParamLayout)
from repro_torch.parallel.sharding import ShardCtx, shard, unflatten

#: the residual stream's logical axes, seq-sharded between blocks
RESIDUAL = ("act_batch", "act_seq", "act_embed")


def _qkv_widths(cfg: ModelConfig):
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    return (h * hd, hkv * hd, hkv * hd)


def init_attn(generator, cfg: ModelConfig, dtype, device,
              layout: ParamLayout = LEGACY_LAYOUT):
    """An attention sublayer's weights: ``wq``/``wk``/``wv`` (or their
    concatenation ``wqkv``), ``wo``, and, with ``qk_norm``, the per-head
    ``q_norm``/``k_norm`` scales (ones of ``head_dim``)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    wq = common.dense_init(generator, (d, h * hd), 0, dtype, device)
    wk = common.dense_init(generator, (d, hkv * hd), 0, dtype, device)
    wv = common.dense_init(generator, (d, hkv * hd), 0, dtype, device)
    attn = {"wo": common.dense_init(generator, (h * hd, d), 0, dtype, device)}
    if layout.attn_qkv:
        attn["wqkv"] = torch.cat([wq, wk, wv], dim=1)
    else:
        attn.update(wq=wq, wk=wk, wv=wv)
    if cfg.qk_norm:
        attn["q_norm"] = torch.ones(hd, dtype=dtype, device=device)
        attn["k_norm"] = torch.ones(hd, dtype=dtype, device=device)
    return attn


def attn_specs(cfg: ModelConfig, layout: ParamLayout = LEGACY_LAYOUT):
    """The logical axes of :func:`init_attn`'s leaves."""
    specs = {"wo": ("q_heads", "embed")}
    if layout.attn_qkv:
        specs["wqkv"] = ("embed", "qkv_heads")
    else:
        specs.update(wq=("embed", "q_heads"), wk=("embed", "kv_heads"),
                     wv=("embed", "kv_heads"))
    if cfg.qk_norm:
        specs.update(q_norm=("head_dim",), k_norm=("head_dim",))
    return specs


def block_specs(cfg: ModelConfig, layout: ParamLayout = LEGACY_LAYOUT):
    """The logical axes of :func:`init_block`'s leaves."""
    specs = {"attn": attn_specs(cfg, layout),
             "ln1": common.norm_specs(cfg.norm),
             "ln2": common.norm_specs(cfg.norm)}
    if cfg.moe is not None:
        specs["moe"] = mlp.moe_specs(cfg.moe, cfg.act, layout)
    else:
        specs["mlp"] = mlp.mlp_specs(cfg.act, layout)
    return specs


def init_block(generator, cfg: ModelConfig, dtype, device,
               layout: ParamLayout = LEGACY_LAYOUT):
    d = cfg.d_model
    params = {
        "attn": init_attn(generator, cfg, dtype, device, layout),
        "ln1": common.init_norm(d, cfg.norm, dtype, device),
        "ln2": common.init_norm(d, cfg.norm, dtype, device),
    }
    if cfg.moe is not None:
        params["moe"] = mlp.init_moe(generator, d, cfg.d_ff, cfg.moe,
                                     cfg.act, dtype, device, layout)
    else:
        params["mlp"] = mlp.init_mlp(generator, d, cfg.d_ff, cfg.act, dtype,
                                     device, layout)
    return params


# --------------------------------------------------------------------------
# Attention sublayer
# --------------------------------------------------------------------------


def _project_qkv(params, x, cfg: ModelConfig, positions, policy,
                 norm_scale=None, ctx=None, constrain_kv: bool = True):
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    if norm_scale is not None:
        # ln1 rides into one projection against [wq|wk|wv]
        w_qkv = common.concat_param(params, "wqkv", ("wq", "wk", "wv"))
        qkv = common.rmsnorm_matmul(x, norm_scale, w_qkv, cfg.norm_eps,
                                    policy=policy,
                                    w_scale=params.get("wqkv_scale"))
        q, k, v = torch.split(qkv, _qkv_widths(cfg), dim=-1)
    else:
        if "wqkv_scale" in params:
            # the int8 concat on the unfused path: dequantized once, then
            # the per-matrix views
            params = dict(params, wqkv=common.dequantize_weight(
                params["wqkv"], params["wqkv_scale"], x.dtype))
        wq, wk, wv = common.split_param(params, "wqkv", ("wq", "wk", "wv"),
                                        _qkv_widths(cfg))
        q = torch.matmul(x, wq.to(x.dtype))
        k = torch.matmul(x, wk.to(x.dtype))
        v = torch.matmul(x, wv.to(x.dtype))
    q = unflatten(q, -1, (h, hd)).transpose(1, 2)
    k = unflatten(k, -1, (hkv, hd)).transpose(1, 2)
    v = unflatten(v, -1, (hkv, hd)).transpose(1, 2)
    if cfg.qk_norm:
        q = common.rmsnorm(q, params["q_norm"], cfg.norm_eps, policy=policy)
        k = common.rmsnorm(k, params["k_norm"], cfg.norm_eps, policy=policy)
    if cfg.pos_emb == "rope":
        q = common.apply_rope(q, positions[:, None, :], cfg.rope_theta)
        k = common.apply_rope(k, positions[:, None, :], cfg.rope_theta)
    q = shard(q, ("act_batch", "act_heads", "act_seq_unsharded",
                  "act_head_dim"), ctx)
    if constrain_kv:
        kv_axes = ("act_batch", "act_kv_heads", "act_seq_unsharded",
                   "act_head_dim")
        k, v = shard(k, kv_axes, ctx), shard(v, kv_axes, ctx)
    return q, k, v


def _wo_weight(params, dtype):
    """The output projection at the math dtype, dequantized when it is
    int8 (the unfused paths; the fused ones take the int8 leaf and its
    scale)."""
    if "wo_scale" in params:
        return common.dequantize_weight(params["wo"], params["wo_scale"],
                                        dtype)
    return params["wo"].to(dtype)


def attn_seq(params, x, cfg: ModelConfig, par: ParallelConfig, positions,
             policy, norm_scale=None, causal: bool = True, ctx=None):
    """Full-sequence attention, causal (a decoder) or not (an encoder) ->
    (out [B,S,D], (k, v) [B,Hkv,S,D]).

    The kernels take the un-repeated k/v and index ``h // group``
    themselves, as does the plain path, the chunked online softmax at the
    policy's chunks (models/attention.py::chunked_attention): there is no
    repeated k/v to constrain.  ``par.rs_outputs`` moves the output to the
    residual's seq-sharded layout."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg, positions, policy, norm_scale,
                           ctx, constrain_kv=par.constrain_kv_pre_repeat)
    if par.use_pallas_attn:
        from repro_torch.kernels import ops as kernel_ops
        if policy.fuses():
            out = kernel_ops.fused_flash_attention_matmul(
                q, k, v, params["wo"], causal=causal, policy=policy.kernel(),
                w_scale=params.get("wo_scale"))
        else:
            o = kernel_ops.flash_attention(q, k, v, causal=causal,
                                           policy=policy.kernel())
            o = o.transpose(1, 2).reshape(b, s, -1)
            out = torch.matmul(o, _wo_weight(params, x.dtype))
    else:
        o = chunked_attention(q, k, v, causal=causal, kv_offset=0,
                              chunk_q=par.attn_chunk_q,
                              chunk_kv=par.attn_chunk_kv,
                              exact_causal=par.causal_folding)
        o = o.transpose(1, 2).reshape(b, s, -1)
        out = torch.matmul(o, _wo_weight(params, x.dtype))
    if par.rs_outputs:
        out = shard(out, RESIDUAL, ctx)
    return out, (k, v)


def attn_decode(params, x_t, cfg: ModelConfig, kv, pos, policy,
                norm_scale=None, fuse_wo: bool = False, block_tables=None,
                int8: bool = False, ctx=None):
    """One-token attention.  ``kv`` is (K, V) [B,Hkv,S,hd], or, with
    ``block_tables``, the (k, v) pools [P+1,Hkv,page_size,hd] (the last
    page is the trash page of models/attention.py); with ``int8`` it is
    (K, K scales, V, V scales), int8 values beside f32 scales of last axis
    1.  The caches are written in place."""
    b = x_t.shape[0]
    q, k_new, v_new = _project_qkv(params, x_t, cfg, pos[:, None], policy,
                                   norm_scale, ctx)
    k_sc = v_sc = None
    if int8:
        k_cache, k_sc, v_cache, v_sc = kv
    else:
        k_cache, v_cache = kv
    if block_tables is not None:
        if int8:
            update_paged_cache_int8(k_cache, k_sc, k_new, block_tables, pos)
            update_paged_cache_int8(v_cache, v_sc, v_new, block_tables, pos)
        else:
            update_paged_cache(k_cache, k_new, block_tables, pos)
            update_paged_cache(v_cache, v_new, block_tables, pos)
        num_pages = k_cache.shape[0] - 1
        k_cache, v_cache = k_cache[:num_pages], v_cache[:num_pages]
        if int8:
            k_sc, v_sc = k_sc[:num_pages], v_sc[:num_pages]
    elif int8:
        update_cache_int8(k_cache, k_sc, k_new, pos)
        update_cache_int8(v_cache, v_sc, v_new, pos)
        # the dense int8 strip is dequantized up front (the kernel reads
        # int8 pools only in the paged shape)
        k_cache = dequantize_kv(k_cache, k_sc, x_t.dtype)
        v_cache = dequantize_kv(v_cache, v_sc, x_t.dtype)
        k_sc = v_sc = None
    else:
        update_cache(k_cache, k_new, pos)
        update_cache(v_cache, v_new, pos)
    if fuse_wo:
        from repro_torch.kernels import ops as kernel_ops
        return kernel_ops.fused_flash_attention_matmul(
            q, k_cache, v_cache, params["wo"], pos=pos,
            block_tables=block_tables, policy=policy.kernel(),
            w_scale=params.get("wo_scale"), k_scale=k_sc, v_scale=v_sc)
    if k_sc is not None:
        # the unfused paged path: the pools dequantized up front
        k_cache = dequantize_kv(k_cache, k_sc, x_t.dtype)
        v_cache = dequantize_kv(v_cache, v_sc, x_t.dtype)
    if block_tables is not None:
        o = paged_decode_attention(q, k_cache, v_cache, block_tables, pos)
    else:
        o = decode_attention(q, k_cache, v_cache, pos)
    o = o.transpose(1, 2).reshape(b, 1, -1)
    return torch.matmul(o, _wo_weight(params, x_t.dtype))


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------


def _mlp_sublayer(params, x, a, cfg: ModelConfig, policy, fuse: bool,
                  swiglu_fuse: bool, ctx=None, rs_outputs: bool = False):
    """Residual add, ln2, MLP (or MoE) -> (x, the MoE's auxiliary
    load-balancing loss, 0.0 for a dense MLP): ln2 rides into [wi|wg] when
    it fuses, else into the residual add (add_rmsnorm) under a fusing
    policy.  ``rs_outputs`` moves the MLP's output to the residual's
    layout before the add."""
    if swiglu_fuse:
        x = x + a
        h, mlp_scale = x, params["ln2"]["scale"]
    elif fuse:
        h, x = common.add_rmsnorm(x, a, params["ln2"]["scale"],
                                  cfg.norm_eps, policy=policy)
        mlp_scale = None
    else:
        x = x + a
        h = common.apply_norm(x, params["ln2"], cfg.norm, cfg.norm_eps,
                              policy=policy)
        mlp_scale = None
    if cfg.moe is not None:
        m, aux = mlp.apply_moe(params["moe"], h, cfg.moe, cfg.act,
                               policy=policy, norm_scale=mlp_scale,
                               eps=cfg.norm_eps, ctx=ctx)
    else:
        m, aux = mlp.apply_mlp(params["mlp"], h, cfg.act, policy=policy,
                               norm_scale=mlp_scale, eps=cfg.norm_eps,
                               ctx=ctx), 0.0
    if rs_outputs:
        m = shard(m, RESIDUAL, ctx)
    return x + m, aux


def _dense_mlp(params, cfg: ModelConfig):
    """The dense MLP whose [wi|wg] pair can absorb ln2: the block's MLP,
    a MoE's shared expert, or none (a router-only MoE)."""
    if cfg.moe is None:
        return params["mlp"]
    return params["moe"]["shared"] if cfg.moe.shared_experts else None


def block_seq(params, x, cfg: ModelConfig, par: ParallelConfig, positions,
              policy, ctx=None):
    """One block over the sequence -> (x, (k, v), aux): aux is the MoE's
    load-balancing loss (0.0 for a dense MLP); x leaves in the residual's
    layout."""
    fuse = policy.fuses() and cfg.norm == "rmsnorm"
    if fuse:
        h, norm_scale = x, params["ln1"]["scale"]
    else:
        h = common.apply_norm(x, params["ln1"], cfg.norm, cfg.norm_eps,
                              policy=policy)
        norm_scale = None
    a, kv = attn_seq(params["attn"], h, cfg, par, positions, policy,
                     norm_scale, ctx=ctx)
    swiglu_fuse = (fuse and cfg.act == "silu"
                   and _dense_mlp(params, cfg) is not None)
    x, aux = _mlp_sublayer(params, x, a, cfg, policy, fuse, swiglu_fuse,
                           ctx, par.rs_outputs)
    return shard(x, RESIDUAL, ctx), kv, aux


def block_decode(params, x_t, cfg: ModelConfig, kv, pos, policy,
                 fuse_wo: bool = False, block_tables=None,
                 int8: bool = False, ctx=None):
    fuse = policy.fuses() and cfg.norm == "rmsnorm"
    # the decode prologues fuse only on the persisted concatenated layout
    if fuse and common.stored_concat(params["attn"], "wqkv"):
        h, ln1_scale = x_t, params["ln1"]["scale"]
    else:
        h = common.apply_norm(x_t, params["ln1"], cfg.norm, cfg.norm_eps,
                              policy=policy)
        ln1_scale = None
    a = attn_decode(params["attn"], h, cfg, kv, pos, policy,
                    norm_scale=ln1_scale, fuse_wo=fuse_wo,
                    block_tables=block_tables, int8=int8, ctx=ctx)
    dense = _dense_mlp(params, cfg)
    swiglu_fuse = (fuse and cfg.act == "silu" and dense is not None
                   and common.stored_concat(dense, "wig"))
    return _mlp_sublayer(params, x_t, a, cfg, policy, fuse, swiglu_fuse,
                         ctx)[0]


# --------------------------------------------------------------------------
# Model
# --------------------------------------------------------------------------


class TransformerLM:
    """Functional decoder-only LM over a stacked parameter dict; ``ctx``
    places its activations on a mesh."""

    def __init__(self, cfg: ModelConfig, par: ParallelConfig,
                 policy: Optional[ExecutionPolicy] = None, device=None,
                 ctx: Optional[ShardCtx] = None):
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"TransformerLM takes the dense, moe and vlm "
                             f"families, not {cfg.family!r}")
        self.cfg = cfg
        self.par = par
        self.ctx = ctx
        self.device = common.resolve_device(device)
        self.policy = policy or par.execution_policy()
        self.param_layout = ParamLayout.plan(cfg, self.policy)
        self.dtype = getattr(torch, cfg.dtype)
        self.aux_weight = 0.01 if cfg.moe is not None else 0.0
        # the JAX package multiplies by sqrt(d_model) rounded to the dtype
        self._embed_scale = float(torch.tensor(cfg.d_model ** 0.5,
                                               dtype=self.dtype))

    def with_policy(self, policy: ExecutionPolicy) -> "TransformerLM":
        return type(self)(self.cfg, self.par, policy=policy,
                          device=self.device, ctx=self.ctx)

    # ---- params ----

    def param_specs(self):
        """The logical axes of :meth:`init_params`' leaves, in the planned
        layout (the stacked layer axis unsharded); nothing is allocated."""
        cfg = self.cfg
        specs = {
            "embed": ("vocab", "embed"),
            "blocks": common.lift_specs(block_specs(cfg, self.param_layout)),
            "final_norm": common.norm_specs(cfg.norm),
        }
        if not cfg.tie_embeddings:
            specs["lm_head"] = ("embed", "vocab")
        return specs

    def init_params(self, seed: int = 0):
        """Random parameters from a seeded generator on the model's device,
        in the layout the policy planned.  Blocks are drawn one layer at a
        time into the stacked tensors, so the f32 draw of one layer is the
        only temporary."""
        cfg, dev = self.cfg, self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        embed = common.embed_init(gen, (cfg.vocab_size, cfg.d_model), dev)
        blocks = None
        for i in range(cfg.num_layers):
            layer = init_block(gen, cfg, self.dtype, dev, self.param_layout)
            if blocks is None:
                blocks = common.stack_like(layer, cfg.num_layers)
            common.copy_into(blocks, layer, i)
        params = {
            "embed": embed,
            "blocks": blocks,
            "final_norm": common.init_norm(cfg.d_model, cfg.norm,
                                           self.dtype, dev),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = common.dense_init(
                gen, (cfg.d_model, cfg.vocab_size), 0, self.dtype, dev)
        return params

    # ---- embedding / head ----

    def _embed(self, params, tokens, batch=None):
        """Token embeddings times ``sqrt(d_model)``; a VLM batch's
        ``patch_embeds`` [B, P, D] go first, cast to the dtype, and take
        the scale too."""
        x = params["embed"][tokens].to(self.dtype)
        if self.cfg.family == "vlm" and batch and "patch_embeds" in batch:
            x = torch.cat([batch["patch_embeds"].to(self.dtype), x], dim=1)
        return shard(x * self._embed_scale,
                     ("act_batch", "act_seq_unsharded", "act_embed"),
                     self.ctx)

    def _head(self, params, x):
        cfg = self.cfg
        w = params.get("lm_head")
        if w is None:
            w = params["embed"].t()
        if cfg.norm == "rmsnorm":
            logits = common.rmsnorm_matmul(x, params["final_norm"]["scale"],
                                           w, cfg.norm_eps,
                                           policy=self.policy)
        else:
            x = common.apply_norm(x, params["final_norm"], cfg.norm,
                                  cfg.norm_eps, policy=self.policy)
            logits = torch.matmul(x, w.to(x.dtype))
        return shard(logits.float(),
                     ("act_batch", "act_seq_unsharded", "act_vocab"),
                     self.ctx)

    # ---- the layer stack ----

    def _blocks(self, params, x, positions, kvs=None, remat: str = "none"):
        """Every block over the sequence -> (x, the summed aux losses: an
        f32 scalar, 0.0 without a MoE); with ``kvs`` (a list) each layer's
        (k, v) is appended to it.  ``remat`` sets what a backward
        recomputes (:func:`common.remat_call`)."""
        def block(layer, h):
            return block_seq(layer, h, self.cfg, self.par, positions,
                             self.policy, self.ctx)
        aux = 0.0
        for layer in common.layer_views(params["blocks"]):
            x, kv, a = common.remat_call(block, remat, layer, x)
            aux = aux + a
            if kvs is not None:
                kvs.append(kv)
        return x, aux

    # ---- public API ----

    def loss_fn(self, params, batch):
        """Token-mean cross entropy of ``batch["labels"]`` plus, for a MoE,
        ``0.01 x`` the layers' mean load-balancing loss -> (total,
        {"ce_loss", "aux_loss"}); a VLM batch's patch positions are cut
        before the head.  Layers remat as ``par.remat`` says."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = self._embed(params, tokens, batch)
        b, s = x.shape[0], x.shape[1]
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        x, aux = self._blocks(params, x, positions, remat=self.par.remat)
        if cfg.family == "vlm" and "patch_embeds" in batch:
            x = x[:, batch["patch_embeds"].shape[1]:]
        loss = common.cross_entropy(self._head(params, x), batch["labels"])
        if not torch.is_tensor(aux):            # no MoE layer: 0.0
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        total = loss + self.aux_weight * aux / max(cfg.num_layers, 1)
        return total, {"ce_loss": loss, "aux_loss": aux}

    def prefill(self, params, batch):
        """Full forward building a decode cache; returns last-pos logits
        [B, V] (f32) and ``{"k", "v": [L,B,Hkv,S,hd], "pos": [B]}``; with
        the int8 KV cache k/v are int8 beside ``"k_scale"``/``"v_scale"``
        [L,B,Hkv,S,1] f32.  A VLM batch's ``patch_embeds`` [B,P,D] precede
        the tokens: S and ``pos`` count the patches and the text."""
        tokens = batch["tokens"]
        x = self._embed(params, tokens, batch)
        b, s = x.shape[0], x.shape[1]
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        kvs = []
        x, _ = self._blocks(params, x, positions, kvs)
        logits = self._head(params, x[:, -1:, :])
        pos = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
        k = torch.stack([kv[0] for kv in kvs])
        v = torch.stack([kv[1] for kv in kvs])
        if self.par.kv_cache_int8:
            k_q, k_s = quantize_kv(k)
            v_q, v_s = quantize_kv(v)
            return logits[:, 0], {"k": k_q, "k_scale": k_s, "v": v_q,
                                  "v_scale": v_s, "pos": pos}
        return logits[:, 0], {"k": k, "v": v, "pos": pos}

    def _kv_tensors(self, shape, suffix: str):
        """The K and V tensors of a cache: zeros at the model's dtype, or,
        under the int8 KV cache, int8 zeros beside f32 scales of last axis
        1, initialized to 1e-8."""
        dev = self.device
        out = {}
        for kv in "kv":
            if not self.par.kv_cache_int8:
                out[kv + suffix] = torch.zeros(shape, dtype=self.dtype,
                                               device=dev)
                continue
            out[kv + suffix] = torch.zeros(shape, dtype=torch.int8,
                                           device=dev)
            out[f"{kv}_scale{suffix}"] = torch.full(
                shape[:-1] + (1,), 1e-8, dtype=torch.float32, device=dev)
        return out

    def init_cache(self, batch_size: int, cache_len: int):
        cfg = self.cfg
        shape = (cfg.num_layers, batch_size, cfg.num_kv_heads, cache_len,
                 cfg.resolved_head_dim)
        return {**self._kv_tensors(shape, ""),
                "pos": torch.zeros(batch_size, dtype=torch.int32,
                                   device=self.device)}

    def init_paged_cache(self, batch_size: int, num_pages: int,
                         page_size: int, max_pages_per_slot: int):
        """Paged form of :meth:`init_cache`: pools ``[L, P+1, Hkv,
        page_size, hd]`` (page ``P`` is the trash page that dropped
        writes land on; int8 pools beside ``*_scale_pages`` ``[L, P+1,
        Hkv, page_size, 1]`` f32) and block tables initialized to the
        sentinel ``P``."""
        cfg = self.cfg
        shape = (cfg.num_layers, num_pages + 1, cfg.num_kv_heads, page_size,
                 cfg.resolved_head_dim)
        return {**self._kv_tensors(shape, "_pages"),
                "block_tables": torch.full((batch_size, max_pages_per_slot),
                                           num_pages, dtype=torch.int32,
                                           device=self.device),
                "pos": torch.zeros(batch_size, dtype=torch.int32,
                                   device=self.device)}

    def cache_specs(self):
        """The logical axes of :meth:`init_cache`'s leaves."""
        kv = (None, "act_cache_batch", "act_kv_heads", "act_kv_seq",
              "act_head_dim")
        if self.par.kv_cache_int8:
            sc = (None, "act_cache_batch", "act_kv_heads", "act_kv_seq",
                  None)
            return {"k": kv, "k_scale": sc, "v": kv, "v_scale": sc,
                    "pos": (None,)}
        return {"k": kv, "v": kv, "pos": (None,)}

    def decode_step(self, params, tokens, cache):
        """tokens [B] -> (logits [B,V] f32, cache with ``pos + 1``).

        The cache's K/V tensors (and, int8, their scales) are updated in
        place.  A cache with ``block_tables`` takes the paged path; the
        int8 KV cache its four-tensor form, dense or paged."""
        cfg = self.cfg
        paged = "block_tables" in cache
        tables = cache["block_tables"] if paged else None
        pos = cache["pos"]
        int8 = self.par.kv_cache_int8
        sfx = "_pages" if paged else ""
        names = ((f"k{sfx}", f"k_scale{sfx}", f"v{sfx}", f"v_scale{sfx}")
                 if int8 else (f"k{sfx}", f"v{sfx}"))
        kv_all = [cache[n] for n in names]
        x = self._embed(params, tokens[:, None])
        fuse_wo = (self.par.use_pallas_attn and self.policy.fuses()
                   and cfg.num_heads > 0)
        for i, layer in enumerate(common.layer_views(params["blocks"])):
            x = block_decode(layer, x, cfg, tuple(t[i] for t in kv_all), pos,
                             self.policy, fuse_wo=fuse_wo,
                             block_tables=tables, int8=int8, ctx=self.ctx)
        logits = self._head(params, x)[:, 0]
        return logits, dict(cache, pos=pos + 1)
