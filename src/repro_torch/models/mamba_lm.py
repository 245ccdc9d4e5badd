"""Attention-free SSM LM (the mamba2-2.7b family).

Parameters are a plain dict of tensors with the JAX package's keys and its
stacked ``[L, ...]`` layout (``embed``, ``blocks``, ``norms``,
``final_norm``, ``lm_head`` unless the embedding is tied); layers run as a
Python loop over layer views.  The cache is ``{"h": [L,B,G,Hg,N,P] f32,
"conv": [L,B,W-1,conv_dim], "pos": [B]}``; decode writes each layer's new
state and conv window into it in place.

Under a fusing policy (``ParallelConfig(fuse_epilogues=True)``) prefill runs
the ssd_scan kernel and decode the ssd_decode kernel, one launch per layer
each, in the policy's kernel mode.  The norms (each layer's input norm,
the gated norm inside each block, the final norm) go through the registry's
rmsnorm in the policy's mode: with ``isa_mode`` None that is the library
row (plain PyTorch), with ``isa_mode=m`` the rmsnorm kernel of mode m, as
in the JAX package: 2 x layers + 1 launches per prefill and per decode
step.  ``loss_fn`` is the token-mean cross entropy; under grad mode and
``ParallelConfig(remat="full")`` each layer is recomputed in the backward,
as the JAX package remats its scan body.  ``ctx`` places the activations
on a mesh at the JAX package's sites (the embedding, each block's heads,
the residual after each layer, the logits).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.registry import ExecutionPolicy
from repro_torch.models import common, ssd
from repro_torch.models.config import ModelConfig, ParallelConfig
from repro_torch.parallel.sharding import ShardCtx, shard


class MambaLM:
    """Functional mamba2 LM over a stacked parameter dict; ``ctx`` places
    its activations on a mesh."""

    #: whether each layer's residual moves to the seq-sharded layout (the
    #: JAX package's mamba LM does; its hybrid's mamba spans do not)
    _shard_residual = True

    def __init__(self, cfg: ModelConfig, par: ParallelConfig,
                 policy: Optional[ExecutionPolicy] = None, device=None,
                 ctx: Optional[ShardCtx] = None):
        if cfg.ssm is None:
            raise ValueError(f"{cfg.name} has no ssm config")
        self.cfg = cfg
        self.par = par
        self.ctx = ctx
        self.device = common.resolve_device(device)
        self.policy = policy or par.execution_policy()
        self.dtype = getattr(torch, cfg.dtype)

    def with_policy(self, policy: ExecutionPolicy) -> "MambaLM":
        return type(self)(self.cfg, self.par, policy=policy,
                          device=self.device, ctx=self.ctx)

    # ---- params ----

    def param_specs(self):
        """The logical axes of :meth:`init_params`' leaves (the stacked
        layer axis unsharded); nothing is allocated."""
        cfg = self.cfg
        specs = {"embed": ("vocab", "embed"),
                 "blocks": common.lift_specs(ssd.mamba_block_specs()),
                 "norms": common.lift_specs(common.norm_specs(cfg.norm)),
                 "final_norm": common.norm_specs(cfg.norm)}
        if not cfg.tie_embeddings:
            specs["lm_head"] = ("embed", "vocab")
        return specs

    def init_params(self, seed: int = 0):
        """Random parameters from a seeded generator on the model's device;
        blocks are drawn one layer at a time into the stacked tensors."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return self._draw_params(gen)

    def _draw_params(self, gen: torch.Generator):
        cfg, dev = self.cfg, self.device
        embed = common.embed_init(gen, (cfg.vocab_size, cfg.d_model), dev)
        blocks = None
        for i in range(cfg.num_layers):
            layer = ssd.init_mamba_block(gen, cfg.d_model, cfg.ssm,
                                         self.dtype, dev)
            if blocks is None:
                blocks = common.stack_like(layer, cfg.num_layers)
            common.copy_into(blocks, layer, i)
        ones = torch.ones(cfg.num_layers, cfg.d_model, dtype=self.dtype,
                          device=dev)
        params = {
            "embed": embed,
            "blocks": blocks,
            "norms": {"scale": ones},
            "final_norm": {"scale": torch.ones(cfg.d_model, dtype=self.dtype,
                                               device=dev)},
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = common.dense_init(
                gen, (cfg.d_model, cfg.vocab_size), 0, self.dtype, dev)
        return params

    # ---- embedding / head ----

    def _embed(self, params, tokens):
        return shard(params["embed"][tokens].to(self.dtype),
                     ("act_batch", "act_seq_unsharded", "act_embed"),
                     self.ctx)

    def _head(self, params, x):
        cfg = self.cfg
        x = common.apply_norm(x, params["final_norm"], cfg.norm,
                              cfg.norm_eps, policy=self.policy)
        w = params.get("lm_head")
        if w is None:
            w = params["embed"].t()
        return shard(torch.matmul(x, w.to(x.dtype)).float(),
                     ("act_batch", "act_seq_unsharded", "act_vocab"),
                     self.ctx)

    # ---- the layer stack ----

    def _layer_views(self, params):
        """[(block, norm)] views of every layer
        (:func:`common.layer_views`)."""
        return list(zip(common.layer_views(params["blocks"]),
                        common.layer_views(params["norms"])))

    def _layer(self, block, norm, x, return_state: bool = False):
        """One layer over the sequence: norm, block, residual add; with
        ``return_state`` -> (x, (final state, conv tail))."""
        cfg = self.cfg
        hin = common.apply_norm(x, norm, cfg.norm, cfg.norm_eps,
                                policy=self.policy)
        out = ssd.apply_mamba_block(block, hin, cfg.ssm, cfg.d_model,
                                    cfg.norm_eps, return_state=return_state,
                                    policy=self.policy, ctx=self.ctx)
        if return_state:
            out, state = out
        x = x + out
        if self._shard_residual:
            x = shard(x, ("act_batch", "act_seq", "act_embed"), self.ctx)
        return (x, state) if return_state else x

    def _layers(self, layers, x, lo: int, hi: int, states=None):
        """Layers ``lo:hi`` of ``layers`` (:meth:`_layer_views`) over the
        sequence; with ``states`` (a list) each layer's (final state, conv
        tail) is appended to it, else each layer remats under
        ``remat="full"`` (the JAX package remats no layer that returns its
        state)."""
        remat = "full" if self.par.remat == "full" else "none"
        for block, norm in layers[lo:hi]:
            if states is None:
                x = common.remat_call(self._layer, remat, block, norm, x)
            else:
                x, state = self._layer(block, norm, x, return_state=True)
                states.append(state)
        return x

    def _layers_decode(self, layers, x, lo: int, hi: int, cache):
        """Layers ``lo:hi`` of ``layers`` (:meth:`_layer_views`) for one
        token, each writing its state and conv window into ``cache`` in
        place."""
        cfg = self.cfg
        for i in range(lo, hi):
            block, norm = layers[i]
            hin = common.apply_norm(x, norm, cfg.norm, cfg.norm_eps,
                                    policy=self.policy)
            x = x + ssd.mamba_decode_step(
                block, hin, cfg.ssm, cfg.d_model, cfg.norm_eps,
                cache["h"][i], cache["conv"][i], policy=self.policy)
        return x

    # ---- public API ----

    def loss_fn(self, params, batch):
        """Token-mean cross entropy of ``batch["labels"]`` -> (loss,
        {"ce_loss"})."""
        x = self._layers(self._layer_views(params),
                         self._embed(params, batch["tokens"]), 0,
                         self.cfg.num_layers)
        loss = common.cross_entropy(self._head(params, x), batch["labels"])
        return loss, {"ce_loss": loss}

    def prefill(self, params, batch):
        """Full forward building a decode cache; returns last-position
        logits [B, V] (f32) and ``{"h", "conv", "pos"}``."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        states = []
        x = self._layers(self._layer_views(params),
                         self._embed(params, tokens), 0, self.cfg.num_layers,
                         states)
        logits = self._head(params, x[:, -1:, :])
        pos = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
        return logits[:, 0], {"h": torch.stack([st[0] for st in states]),
                              "conv": torch.stack([st[1] for st in states]),
                              "pos": pos}

    def init_cache(self, batch_size: int, cache_len: int):
        """Zero state and conv history for ``batch_size`` slots (the state
        does not grow with the sequence: ``cache_len`` is not used)."""
        cfg, s = self.cfg, self.cfg.ssm
        nh = s.expand * cfg.d_model // s.head_dim
        g = s.n_groups
        return {
            "h": torch.zeros(cfg.num_layers, batch_size, g, nh // g,
                             s.state_dim, s.head_dim, dtype=torch.float32,
                             device=self.device),
            "conv": torch.zeros(cfg.num_layers, batch_size, s.conv_width - 1,
                                ssd.conv_dim(s, cfg.d_model),
                                dtype=self.dtype, device=self.device),
            "pos": torch.zeros(batch_size, dtype=torch.int32,
                               device=self.device),
        }

    def cache_specs(self):
        """The logical axes of :meth:`init_cache`'s leaves."""
        return {
            "h": (None, "act_cache_batch", None, "act_ssm_heads",
                  "act_ssm_state", None),
            "conv": (None, "act_cache_batch", None, "ssm_inner"),
            "pos": (None,),
        }

    def decode_step(self, params, tokens, cache):
        """tokens [B] -> (logits [B,V] f32, cache with ``pos + 1``); the
        cache's ``h`` and ``conv`` are updated in place."""
        x = self._layers_decode(self._layer_views(params),
                                self._embed(params, tokens), 0,
                                self.cfg.num_layers, cache)
        logits = self._head(params, x[:, None, :])[:, 0]
        return logits, dict(cache, pos=cache["pos"] + 1)
