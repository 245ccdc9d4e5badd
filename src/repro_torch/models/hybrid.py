"""Hybrid SSM + shared-attention LM (the zamba2 family, arXiv:2411.15242).

A backbone of mamba2 blocks with ONE transformer block whose weights are
shared across periodic applications: after every ``attn_every`` mamba
layers the shared block runs once, ``n_apps = num_layers // attn_every``
times in all, and the mamba layers past the last full period follow the
last application.  Zamba2's per-application LoRA deltas and its
embedding-concat input are left out, as in the JAX package; the weight
sharing and the cache layout are the reference's.

Parameters are a plain dict of tensors with the JAX package's keys:
``embed``, the stacked ``[L, ...]`` ``blocks`` and ``norms`` of the mamba
layers, ``shared_attn`` (one transformer block, in the layout the policy
plans: ``wqkv`` and ``wig`` concatenated under a fusing policy),
``final_norm`` and ``lm_head``.  The cache is ``{"h": [L,B,G,Hg,N,P] f32,
"conv": [L,B,W-1,conv_dim], "attn_k", "attn_v": [n_apps,B,Hkv,S,hd],
"pos": [B]}``; decode writes the states, the conv windows and the shared
block's K/V rows into it in place.

Kernels: the mamba layers, the embedding and the head are
:class:`~repro_torch.models.mamba_lm.MambaLM`'s (ssd_scan in prefill,
ssd_decode in decode, the norms through the registry's rmsnorm in the
policy's mode; the head the final norm, then a plain product with
``lm_head``).  The shared block's prefill goes through
``transformer.block_seq`` under the model's ``ParallelConfig`` (causal
flash_attention_matmul under the fused policy, flash_attention under
``use_pallas_attn`` alone), its decode through ``transformer.block_decode``
without ``fuse_wo``, so the decode attention and ``wo`` are plain PyTorch,
as the reference's ``attn_decode`` computes them.
No paged cache (the reference has none).  ``loss_fn`` is the token-mean
cross entropy, the mamba layers remat as MambaLM's, the shared block not
(as in the JAX package).  ``ctx`` places the activations on a mesh at the
JAX package's sites: MambaLM's, less the residual after each mamba layer,
and the shared block's.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.registry import ExecutionPolicy
from repro_torch.models import common, transformer
from repro_torch.models.config import ModelConfig, ParallelConfig, ParamLayout
from repro_torch.models.mamba_lm import MambaLM
from repro_torch.parallel.sharding import ShardCtx


class HybridLM(MambaLM):
    """Functional zamba2-style LM over a parameter dict: MambaLM's layer
    stack, embedding and head, with the shared block between spans."""

    _shard_residual = False

    def __init__(self, cfg: ModelConfig, par: ParallelConfig,
                 policy: Optional[ExecutionPolicy] = None, device=None,
                 ctx: Optional[ShardCtx] = None):
        if cfg.hybrid is None:
            raise ValueError(f"{cfg.name} has no hybrid config")
        super().__init__(cfg, par, policy=policy, device=device, ctx=ctx)
        # the shared block takes the same init-time layout plan as
        # TransformerLM (the mamba blocks have no fusable weight pairs)
        self.param_layout = ParamLayout.plan(cfg, self.policy)
        self.n_apps = cfg.num_layers // cfg.hybrid.attn_every

    # ---- params ----

    def param_specs(self):
        """MambaLM's specs (``lm_head`` untied), and the shared block's in
        the planned layout; nothing is allocated."""
        specs = dict(super().param_specs(),
                     shared_attn=transformer.block_specs(self.cfg,
                                                         self.param_layout))
        specs["lm_head"] = ("embed", "vocab")
        return specs

    def init_params(self, seed: int = 0):
        """MambaLM's parameters (``lm_head`` untied), then the shared block
        in the layout the policy planned, from one seeded generator on the
        model's device."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        params = self._draw_params(gen)
        params["shared_attn"] = transformer.init_block(
            gen, self.cfg, self.dtype, self.device, self.param_layout)
        return params

    def _layer_groups(self):
        """[(start, end)] mamba index ranges with the shared block after
        each, and the trailing range without it."""
        period = self.cfg.hybrid.attn_every
        groups = [(i * period, (i + 1) * period) for i in range(self.n_apps)]
        return groups, (self.n_apps * period, self.cfg.num_layers)

    def _forward(self, params, tokens, states=None, kvs=None):
        """The mamba spans with the shared block after each full period;
        with ``states`` and ``kvs`` (lists) every mamba layer's (state, conv
        tail) and every application's (k, v) are appended to them."""
        b, s = tokens.shape
        x = self._embed(params, tokens)
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        layers = self._layer_views(params)
        groups, (lo, hi) = self._layer_groups()
        for g_lo, g_hi in groups:
            x = self._layers(layers, x, g_lo, g_hi, states)
            x, kv, _ = transformer.block_seq(params["shared_attn"], x,
                                             self.cfg, self.par, positions,
                                             self.policy, self.ctx)
            if kvs is not None:
                kvs.append(kv)
        return self._layers(layers, x, lo, hi, states)

    # ---- public API ----

    def loss_fn(self, params, batch):
        """Token-mean cross entropy of ``batch["labels"]`` -> (loss,
        {"ce_loss"})."""
        x = self._forward(params, batch["tokens"])
        loss = common.cross_entropy(self._head(params, x), batch["labels"])
        return loss, {"ce_loss": loss}

    def prefill(self, params, batch):
        """Full forward building a decode cache; returns last-position
        logits [B, V] (f32) and ``{"h", "conv", "attn_k", "attn_v",
        "pos"}``."""
        tokens = batch["tokens"]
        states, kvs = [], []
        x = self._forward(params, tokens, states, kvs)
        logits = self._head(params, x[:, -1:, :])
        pos = torch.full((tokens.shape[0],), tokens.shape[1],
                         dtype=torch.int32, device=tokens.device)
        return logits[:, 0], {
            "h": torch.stack([st[0] for st in states]),
            "conv": torch.stack([st[1] for st in states]),
            "attn_k": torch.stack([kv[0] for kv in kvs]),
            "attn_v": torch.stack([kv[1] for kv in kvs]),
            "pos": pos}

    def init_cache(self, batch_size: int, cache_len: int):
        """MambaLM's zero states and conv histories, and zero shared-block
        K/V strips of ``cache_len`` positions, for ``batch_size`` slots."""
        cfg = self.cfg
        shape = (self.n_apps, batch_size, cfg.num_kv_heads, cache_len,
                 cfg.resolved_head_dim)
        return dict(super().init_cache(batch_size, cache_len),
                    attn_k=torch.zeros(shape, dtype=self.dtype,
                                       device=self.device),
                    attn_v=torch.zeros(shape, dtype=self.dtype,
                                       device=self.device))

    def cache_specs(self):
        """The logical axes of :meth:`init_cache`'s leaves."""
        kv = (None, "act_cache_batch", "act_kv_heads", "act_kv_seq",
              "act_head_dim")
        return dict(super().cache_specs(), attn_k=kv, attn_v=kv)

    def decode_step(self, params, tokens, cache):
        """tokens [B] -> (logits [B,V] f32, cache with ``pos + 1``); the
        cache's ``h``, ``conv``, ``attn_k`` and ``attn_v`` are updated in
        place."""
        pos = cache["pos"]
        x = self._embed(params, tokens)
        layers = self._layer_views(params)
        groups, (lo, hi) = self._layer_groups()
        for app, (g_lo, g_hi) in enumerate(groups):
            x = self._layers_decode(layers, x, g_lo, g_hi, cache)
            x = transformer.block_decode(
                params["shared_attn"], x[:, None, :], self.cfg,
                (cache["attn_k"][app], cache["attn_v"][app]), pos,
                self.policy, ctx=self.ctx)[:, 0, :]
        x = self._layers_decode(layers, x, lo, hi, cache)
        logits = self._head(params, x[:, None, :])[:, 0]
        return logits, dict(cache, pos=pos + 1)
