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
No paged cache (the reference has none).  ``loss_fn`` comes with the
training slice and the sharding specs with the scale-out slice (ROADMAP,
"Training and checkpoints", "Scale-out").
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.registry import ExecutionPolicy
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig, ParallelConfig, ParamLayout
from repro_torch.models.mamba_lm import MambaLM


class HybridLM(MambaLM):
    """Functional zamba2-style LM over a parameter dict: MambaLM's layer
    stack, embedding and head, with the shared block between spans."""

    def __init__(self, cfg: ModelConfig, par: ParallelConfig,
                 policy: Optional[ExecutionPolicy] = None, device=None):
        if cfg.hybrid is None:
            raise ValueError(f"{cfg.name} has no hybrid config")
        super().__init__(cfg, par, policy=policy, device=device)
        # the shared block takes the same init-time layout plan as
        # TransformerLM (the mamba blocks have no fusable weight pairs)
        self.param_layout = ParamLayout.plan(cfg, self.policy)
        self.n_apps = cfg.num_layers // cfg.hybrid.attn_every

    # ---- params ----

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

    # ---- public API ----

    def prefill(self, params, batch):
        """Full forward building a decode cache; returns last-position
        logits [B, V] (f32) and ``{"h", "conv", "attn_k", "attn_v",
        "pos"}``."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = self._embed(params, tokens)
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        groups, (lo, hi) = self._layer_groups()
        states, ks, vs = [], [], []
        for g_lo, g_hi in groups:
            x = self._layers(params, x, g_lo, g_hi, states)
            x, (k, v) = transformer.block_seq(params["shared_attn"], x,
                                              self.cfg, self.par, positions,
                                              self.policy)
            ks.append(k)
            vs.append(v)
        x = self._layers(params, x, lo, hi, states)
        logits = self._head(params, x[:, -1:, :])
        pos = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
        return logits[:, 0], {
            "h": torch.stack([st[0] for st in states]),
            "conv": torch.stack([st[1] for st in states]),
            "attn_k": torch.stack(ks), "attn_v": torch.stack(vs),
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

    def decode_step(self, params, tokens, cache):
        """tokens [B] -> (logits [B,V] f32, cache with ``pos + 1``); the
        cache's ``h``, ``conv``, ``attn_k`` and ``attn_v`` are updated in
        place."""
        pos = cache["pos"]
        x = self._embed(params, tokens)
        groups, (lo, hi) = self._layer_groups()
        for app, (g_lo, g_hi) in enumerate(groups):
            x = self._layers_decode(params, x, g_lo, g_hi, cache)
            x = transformer.block_decode(
                params["shared_attn"], x[:, None, :], self.cfg,
                (cache["attn_k"][app], cache["attn_v"][app]), pos,
                self.policy)[:, 0, :]
        x = self._layers_decode(params, x, lo, hi, cache)
        logits = self._head(params, x[:, None, :])[:, 0]
        return logits, dict(cache, pos=pos + 1)
