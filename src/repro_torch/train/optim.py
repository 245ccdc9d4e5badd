"""AdamW with f32 master weights, a cosine schedule, global-norm clipping
and error-feedback gradient compression: the JAX package's
``train/optim.py`` formula, leaf for leaf.

State: ``{"step": int32 0-d, "m", "v", "master": f32 trees like the
params}``, plus ``"ef"`` (the int8 residual) under ``compression=
"int8_ef"``.  ``step`` lives on the params' device, and the learning rate,
the bias corrections and the clip factor are 0-d f32 tensors computed
there, so an update makes no host sync.  ``m``, ``v``, ``master`` (and
``ef``) and the params are updated in place under ``torch.no_grad()``, one
leaf at a time: the values are those of JAX's functional form, and the
extra memory is one leaf's temporaries, not a second copy of the 12 bytes
a parameter of f32 state (the trees are stacked ``[L, ...]``, so a model
has a dozen or so leaves).

Gradient compression (``OptConfig.compression``; ``build_train_step``
holds it to the model's ``ParallelConfig.grad_compression``):
  none     gradients taken in f32 as they are;
  bf16     rounded through bf16 (the bf16 wire format);
  int8_ef  error feedback: ``t = g + e``, ``q = Q(t)``, ``e' = t - D(q)``,
           and the update uses ``D(q)`` (``parallel/compress.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from repro_torch import tree
from repro_torch.parallel.compress import dequantize_int8, quantize_int8


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 200
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    compression: str = "none"     # none | bf16 | int8_ef


# --------------------------------------------------------------------------
# the schedule and the state
# --------------------------------------------------------------------------


def lr_at_step(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_ratio x lr``, in f32 (on
    ``step``'s device when it is a tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    denom = max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps) / denom, 0.0, 1.0)
    cos = cfg.lr * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio)
                    * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params, cfg: OptConfig) -> Dict[str, Any]:
    """Zero moments, an f32 copy of the params as masters, and step 0, on
    the params' device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = tree.leaves(params)[0].device
    state = {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": tree.map(zeros, params),
        "v": tree.map(zeros, params),
        "master": tree.map(
            lambda p: p.detach().to(torch.float32, copy=True), params),
    }
    if cfg.compression == "int8_ef":
        state["ef"] = tree.map(zeros, params)
    return state


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    return torch.sqrt(torch.stack(
        [g.float().square().sum() for g in tree.leaves(grads)]).sum())


def _compress(g, ef, mode: str):
    """One leaf's gradient as the update sees it (f32); ``ef`` (the
    leaf's int8 residual) is updated in place."""
    if mode == "none":
        return g.float()
    if mode == "bf16":
        return g.to(torch.bfloat16).float()
    if mode == "int8_ef":
        t = g.float() + ef
        deq = dequantize_int8(*quantize_int8(t))
        ef.copy_(t - deq)
        return deq
    raise ValueError(f"unknown compression {mode!r}")


@torch.no_grad()
def adamw_update(grads, state, params, cfg: OptConfig):
    """One AdamW step -> (params, state, stats), both updated in place;
    ``stats`` holds ``grad_norm``, ``lr`` and ``clip_factor`` (0-d f32 on
    the params' device)."""
    g_flat, p_flat = tree.flatten(grads), tree.flatten(params)
    keys = list(p_flat)
    ef = tree.flatten(state["ef"]) if cfg.compression == "int8_ef" else {}
    g_flat = {k: _compress(g_flat[k], ef.get(k), cfg.compression)
              for k in keys}

    gnorm = global_norm(g_flat)
    clip = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-12),
                           1.0)
    state["step"] += 1
    step = state["step"].to(torch.float32)
    lr = lr_at_step(cfg, state["step"])
    b1c = 1.0 - torch.pow(cfg.b1, step)
    b2c = 1.0 - torch.pow(cfg.b2, step)
    m, v, master = (tree.flatten(state[n]) for n in ("m", "v", "master"))
    for k in keys:
        g = g_flat.pop(k) * clip
        m[k].mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v[k].mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        upd = (m[k] / b1c) / (torch.sqrt(v[k] / b2c) + cfg.eps) \
            + cfg.weight_decay * master[k]
        master[k].sub_(lr * upd)
        p_flat[k].copy_(master[k])
    stats = {"grad_norm": gnorm, "lr": lr, "clip_factor": clip}
    return params, state, stats

