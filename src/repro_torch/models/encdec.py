"""Encoder-decoder transformer (the whisper-base backbone,
arXiv:2212.04356).

The conv audio frontend is a stub, as in the JAX package: the caller hands
over precomputed frame embeddings ``batch["frames"]`` [B, num_frames,
d_model].  The encoder adds sinusoidal positions and runs non-causal
self-attention blocks; the decoder adds learned positions (``pos_embed``)
and runs causal self-attention, cross-attention over the encoder memory
and a gelu MLP; the head is the tied embedding.

Parameters are a plain dict of tensors with the JAX package's keys:
``embed``, ``pos_embed``, the stacked ``[L, ...]`` ``enc_blocks``
(transformer blocks) and ``dec_blocks`` (``self_attn``, ``cross_attn``,
``mlp``, ``ln1``-``ln3``), ``enc_norm`` and ``final_norm``.  The cache is
``{"k", "v": [L,B,Hkv,S,hd], "memory": [B,F,D], "pos": [B]}``; a decode
step writes its K/V rows in place and, as the JAX package does, projects
the cross-attention K/V from ``memory`` anew in every layer of every step
(they are not cached).

Kernels: under the fused policy (``fuse_epilogues=True,
use_pallas_attn=True``) the encoder's non-causal and the decoder's causal
prefill self-attention run flash_attention_matmul (attention + wo);
``flash_attention`` under ``use_pallas_attn`` alone.  Everything else is
plain PyTorch in every policy, as the JAX package leaves it to XLA: the
layernorms (a layernorm model fuses no norm), the projections, the gelu
MLPs, the cross-attention (``chunked_attention`` at prefill, one query
against the memory at decode), the decode self-attention (no ``fuse_wo``)
and the tied head.  A decode step launches no kernel.  No paged cache and
no engine serving: the JAX engine prefills ``{"tokens"}`` alone, so an
encoder-decoder runs through ``prefill`` then ``decode_step``.
``loss_fn`` is the decoder's token-mean cross entropy; under grad mode and
``ParallelConfig(remat="full")`` every encoder and decoder layer is
recomputed in the backward, as the JAX package remats both scans.
``ctx`` places the activations on a mesh at the JAX package's sites (the
frames, the cross K/V, the self-attention's q/k/v, the MLPs' hidden
activations, each decoder block's residual, the embedding and the
logits).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.registry import ExecutionPolicy
from repro_torch.models import common, mlp, transformer
from repro_torch.models.attention import chunked_attention, decode_attention
from repro_torch.models.config import ModelConfig, ParallelConfig
from repro_torch.parallel.sharding import ShardCtx, shard, unflatten


def _init_cross_attn(generator, cfg: ModelConfig, dtype, device):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    return {
        "wq": common.dense_init(generator, (d, h * hd), 0, dtype, device),
        "wk": common.dense_init(generator, (d, hkv * hd), 0, dtype, device),
        "wv": common.dense_init(generator, (d, hkv * hd), 0, dtype, device),
        "wo": common.dense_init(generator, (h * hd, d), 0, dtype, device),
    }


def dec_block_specs(cfg: ModelConfig):
    """The logical axes of :func:`init_dec_block`'s leaves."""
    return {"self_attn": transformer.attn_specs(cfg),
            "cross_attn": {"wq": ("embed", "q_heads"),
                           "wk": ("embed", "kv_heads"),
                           "wv": ("embed", "kv_heads"),
                           "wo": ("q_heads", "embed")},
            "mlp": mlp.mlp_specs(cfg.act),
            "ln1": common.norm_specs(cfg.norm),
            "ln2": common.norm_specs(cfg.norm),
            "ln3": common.norm_specs(cfg.norm)}


def init_dec_block(generator, cfg: ModelConfig, dtype, device):
    d = cfg.d_model
    return {
        "self_attn": transformer.init_attn(generator, cfg, dtype, device),
        "cross_attn": _init_cross_attn(generator, cfg, dtype, device),
        "mlp": mlp.init_mlp(generator, d, cfg.d_ff, cfg.act, dtype, device),
        "ln1": common.init_norm(d, cfg.norm, dtype, device),
        "ln2": common.init_norm(d, cfg.norm, dtype, device),
        "ln3": common.init_norm(d, cfg.norm, dtype, device),
    }


def _heads(t, n: int, hd: int):
    """[B, S, n*hd] -> [B, n, S, hd]."""
    return unflatten(t, -1, (n, hd)).transpose(1, 2)


def _cross_kv(params, memory, cfg: ModelConfig, ctx=None):
    """The encoder memory projected to cross-attention K/V [B,Hkv,F,hd]."""
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    k = torch.matmul(memory, params["wk"].to(memory.dtype))
    v = torch.matmul(memory, params["wv"].to(memory.dtype))
    axes = ("act_batch", "act_kv_heads", "act_frames", "act_head_dim")
    return (shard(_heads(k, hkv, hd), axes, ctx),
            shard(_heads(v, hkv, hd), axes, ctx))


def _cross_attend(params, x, k, v, cfg: ModelConfig, par: ParallelConfig):
    """x [B,S,D] queries against the memory's K/V [B,Hkv,F,hd]."""
    b, s, _ = x.shape
    q = _heads(torch.matmul(x, params["wq"].to(x.dtype)), cfg.num_heads,
               cfg.resolved_head_dim)
    o = chunked_attention(q, k, v, causal=False, chunk_q=par.attn_chunk_q,
                          chunk_kv=par.attn_chunk_kv)
    o = o.transpose(1, 2).reshape(b, s, -1)
    return torch.matmul(o, params["wo"].to(x.dtype))


def dec_block_seq(params, x, memory_kv, cfg: ModelConfig,
                  par: ParallelConfig, positions, policy, ctx=None):
    """One decoder block over the whole prompt -> (x, (k, v))."""
    h = common.apply_norm(x, params["ln1"], cfg.norm, cfg.norm_eps,
                          policy=policy)
    a, kv = transformer.attn_seq(params["self_attn"], h, cfg, par,
                                 positions, policy, ctx=ctx)
    x = x + a
    h = common.apply_norm(x, params["ln2"], cfg.norm, cfg.norm_eps,
                          policy=policy)
    x = x + _cross_attend(params["cross_attn"], h, *memory_kv, cfg, par)
    h = common.apply_norm(x, params["ln3"], cfg.norm, cfg.norm_eps,
                          policy=policy)
    x = x + mlp.apply_mlp(params["mlp"], h, cfg.act, ctx=ctx)
    return shard(x, transformer.RESIDUAL, ctx), kv


def dec_block_decode(params, x_t, memory_kv, cfg: ModelConfig, kv, pos,
                     policy, ctx=None):
    """One decoder block for one token a slot; ``kv`` (K, V)
    [B,Hkv,S,hd] is written at ``pos`` in place."""
    h = common.apply_norm(x_t, params["ln1"], cfg.norm, cfg.norm_eps,
                          policy=policy)
    x_t = x_t + transformer.attn_decode(params["self_attn"], h, cfg, kv, pos,
                                        policy, ctx=ctx)
    h = common.apply_norm(x_t, params["ln2"], cfg.norm, cfg.norm_eps,
                          policy=policy)
    b = x_t.shape[0]
    cross = params["cross_attn"]
    q = _heads(torch.matmul(h, cross["wq"].to(h.dtype)), cfg.num_heads,
               cfg.resolved_head_dim)
    mk, mv = memory_kv
    # every frame visible: the frontier at the memory's last row
    every = torch.full((b,), mk.shape[2] - 1, dtype=torch.int32,
                       device=x_t.device)
    o = decode_attention(q, mk, mv, every).transpose(1, 2).reshape(b, 1, -1)
    x_t = x_t + torch.matmul(o, cross["wo"].to(x_t.dtype))
    h = common.apply_norm(x_t, params["ln3"], cfg.norm, cfg.norm_eps,
                          policy=policy)
    return x_t + mlp.apply_mlp(params["mlp"], h, cfg.act, ctx=ctx)


class EncDecLM:
    """Functional whisper-family LM over a parameter dict: an encoder and
    a decoder, layers run as Python loops over layer views; ``ctx``
    places its activations on a mesh."""

    def __init__(self, cfg: ModelConfig, par: ParallelConfig,
                 policy: Optional[ExecutionPolicy] = None, device=None,
                 ctx: Optional[ShardCtx] = None):
        if cfg.encdec is None:
            raise ValueError(f"{cfg.name} has no encdec config")
        self.cfg = cfg
        self.par = par
        self.ctx = ctx
        self.device = common.resolve_device(device)
        self.policy = policy or par.execution_policy()
        self.dtype = getattr(torch, cfg.dtype)

    def with_policy(self, policy: ExecutionPolicy) -> "EncDecLM":
        return type(self)(self.cfg, self.par, policy=policy,
                          device=self.device, ctx=self.ctx)

    # ---- params ----

    def param_specs(self):
        """The logical axes of :meth:`init_params`' leaves (the stacked
        layer axes unsharded); nothing is allocated."""
        cfg = self.cfg
        return {"embed": ("vocab", "embed"),
                "pos_embed": (None, "embed"),
                "enc_blocks": common.lift_specs(
                    transformer.block_specs(cfg)),
                "dec_blocks": common.lift_specs(dec_block_specs(cfg)),
                "enc_norm": common.norm_specs(cfg.norm),
                "final_norm": common.norm_specs(cfg.norm)}

    def init_params(self, seed: int = 0):
        """Random parameters from a seeded generator on the model's
        device; blocks are drawn one layer at a time into the stacked
        tensors (the per-matrix layout: a layernorm model fuses none)."""
        cfg, dev, dtype = self.cfg, self.device, self.dtype
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

        def stacked(n, draw):
            blocks = None
            for i in range(n):
                layer = draw()
                if blocks is None:
                    blocks = common.stack_like(layer, n)
                common.copy_into(blocks, layer, i)
            return blocks
        return {
            "embed": common.embed_init(gen, (cfg.vocab_size, cfg.d_model),
                                       dev),
            "pos_embed": common.embed_init(gen, (cfg.max_seq_len,
                                                 cfg.d_model), dev),
            "enc_blocks": stacked(cfg.encdec.encoder_layers,
                                  lambda: transformer.init_block(
                                      gen, cfg, dtype, dev)),
            "dec_blocks": stacked(cfg.num_layers, lambda: init_dec_block(
                gen, cfg, dtype, dev)),
            "enc_norm": common.init_norm(cfg.d_model, cfg.norm, dtype, dev),
            "final_norm": common.init_norm(cfg.d_model, cfg.norm, dtype,
                                           dev),
        }

    # ---- encoder ----

    def _enc_layer(self, layer, x, positions):
        cfg = self.cfg
        hn = common.apply_norm(x, layer["ln1"], cfg.norm, cfg.norm_eps,
                               policy=self.policy)
        a, _ = transformer.attn_seq(layer["attn"], hn, cfg, self.par,
                                    positions, self.policy, causal=False,
                                    ctx=self.ctx)
        x = x + a
        hn = common.apply_norm(x, layer["ln2"], cfg.norm, cfg.norm_eps,
                               policy=self.policy)
        return x + mlp.apply_mlp(layer["mlp"], hn, cfg.act, ctx=self.ctx)

    def encode(self, params, frames, remat: str = "none"):
        """frames [B,F,D] (the stub frontend's output) -> memory [B,F,D];
        ``remat`` as :func:`common.remat_call` takes it, per layer."""
        cfg = self.cfg
        x = frames.to(self.dtype)
        x = x + common.sinusoidal_positions(
            x.shape[1], cfg.d_model, x.device).to(x.dtype)[None]
        x = shard(x, ("act_batch", "act_frames", "act_embed"), self.ctx)
        b, f = x.shape[0], x.shape[1]
        positions = torch.arange(f, device=x.device).expand(b, f)
        for layer in common.layer_views(params["enc_blocks"]):
            x = common.remat_call(self._enc_layer, remat, layer, x,
                                  positions)
        return common.apply_norm(x, params["enc_norm"], cfg.norm,
                                 cfg.norm_eps, policy=self.policy)

    # ---- decoder ----

    def _embed_tokens(self, params, tokens, pos_offset=None):
        """Token embeddings plus learned positions: the first S rows of
        ``pos_embed`` at prefill, row ``pos[b]`` for slot b at decode."""
        x = params["embed"][tokens].to(self.dtype)
        if pos_offset is None:
            x = x + params["pos_embed"][:x.shape[1]].to(x.dtype)[None]
        else:
            pe = params["pos_embed"][pos_offset.long()]
            x = x + pe.to(x.dtype)[:, None, :]
        return shard(x, ("act_batch", "act_seq_unsharded", "act_embed"),
                     self.ctx)

    def _head(self, params, x):
        """The final norm, then the tied embedding (a plain product)."""
        cfg = self.cfg
        x = common.apply_norm(x, params["final_norm"], cfg.norm,
                              cfg.norm_eps, policy=self.policy)
        return shard(torch.matmul(x, params["embed"].to(x.dtype).t()).float(),
                     ("act_batch", "act_seq_unsharded", "act_vocab"),
                     self.ctx)

    def _dec_layer(self, layer, x, memory, positions):
        """One decoder layer, its cross K/V projected from ``memory`` ->
        (x, (k, v))."""
        mem_kv = _cross_kv(layer["cross_attn"], memory, self.cfg, self.ctx)
        return dec_block_seq(layer, x, mem_kv, self.cfg, self.par, positions,
                             self.policy, self.ctx)

    # ---- public API ----

    def loss_fn(self, params, batch):
        """The decoder's token-mean cross entropy of ``batch["labels"]``
        over ``batch["frames"]`` and ``batch["tokens"]`` -> (loss,
        {"ce_loss"})."""
        # the JAX package remats both stacks under "full" alone
        remat = "full" if self.par.remat == "full" else "none"
        memory = self.encode(params, batch["frames"], remat)
        x = self._embed_tokens(params, batch["tokens"])
        b, s = x.shape[0], x.shape[1]
        positions = torch.arange(s, device=x.device).expand(b, s)
        for layer in common.layer_views(params["dec_blocks"]):
            x, _ = common.remat_call(self._dec_layer, remat, layer, x, memory,
                                     positions)
        loss = common.cross_entropy(self._head(params, x), batch["labels"])
        return loss, {"ce_loss": loss}

    def prefill(self, params, batch):
        """Encode ``batch["frames"]``, run the decoder over
        ``batch["tokens"]``; returns last-position logits [B, V] (f32) and
        the cache ``{"k", "v", "memory", "pos"}``."""
        memory = self.encode(params, batch["frames"])
        x = self._embed_tokens(params, batch["tokens"])
        b, s = x.shape[0], x.shape[1]
        positions = torch.arange(s, device=x.device).expand(b, s)
        ks, vs = [], []
        for layer in common.layer_views(params["dec_blocks"]):
            x, (k, v) = self._dec_layer(layer, x, memory, positions)
            ks.append(k)
            vs.append(v)
        logits = self._head(params, x[:, -1:, :])
        pos = torch.full((b,), s, dtype=torch.int32, device=x.device)
        return logits[:, 0], {"k": torch.stack(ks), "v": torch.stack(vs),
                              "memory": memory, "pos": pos}

    def init_cache(self, batch_size: int, cache_len: int):
        cfg = self.cfg
        shape = (cfg.num_layers, batch_size, cfg.num_kv_heads, cache_len,
                 cfg.resolved_head_dim)
        dev = self.device
        return {
            "k": torch.zeros(shape, dtype=self.dtype, device=dev),
            "v": torch.zeros(shape, dtype=self.dtype, device=dev),
            "memory": torch.zeros((batch_size, cfg.encdec.num_frames,
                                   cfg.d_model), dtype=self.dtype,
                                  device=dev),
            "pos": torch.zeros(batch_size, dtype=torch.int32, device=dev),
        }

    def cache_specs(self):
        """The logical axes of :meth:`init_cache`'s leaves."""
        kv = (None, "act_cache_batch", "act_kv_heads", "act_kv_seq",
              "act_head_dim")
        return {"k": kv, "v": kv,
                "memory": ("act_batch", "act_frames", "act_embed"),
                "pos": (None,)}

    def decode_step(self, params, tokens, cache):
        """tokens [B] -> (logits [B,V] f32, cache with ``pos + 1``); the
        cache's K/V are written in place."""
        cfg = self.cfg
        pos = cache["pos"]
        memory = cache["memory"]
        x = self._embed_tokens(params, tokens[:, None], pos_offset=pos)
        for i, layer in enumerate(common.layer_views(params["dec_blocks"])):
            mem_kv = _cross_kv(layer["cross_attn"], memory, cfg, self.ctx)
            x = dec_block_decode(layer, x, mem_kv, cfg,
                                 (cache["k"][i], cache["v"][i]), pos,
                                 self.policy, self.ctx)
        logits = self._head(params, x)[:, 0]
        return logits, dict(cache, pos=pos + 1)
