"""Train and eval steps: the loss's gradients by autograd through the plain
PyTorch versions, microbatch accumulation in f32, and AdamW
(``train/optim.py``), as the JAX package's ``train/step.py`` builds them.

The port's kernels have no backward, and neither have the JAX package's:
JAX cannot differentiate a model whose policy routes an op into a Pallas
kernel.  :func:`build_train_step` therefore refuses such a policy
(``ValueError``), and every kernel wrapper refuses an operand that requires
grad under grad mode (``kernels/_launch.py::check_device``), so no gradient
is cut without a word.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import tree
from repro_torch.core.registry import ExecutionPolicy
from repro_torch.train.optim import OptConfig, adamw_update, init_opt_state


def _split_microbatches(batch: Dict[str, torch.Tensor], n: int):
    """[B, ...] -> n microbatches of [B/n, ...] for every batch leaf."""
    def split(x):
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} does not split into "
                             f"{n} microbatches")
        return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def check_trainable(model) -> None:
    """Raise ``ValueError`` when the model's policy routes any op into a
    kernel: a fused lowering, the attention kernels, or a kernel mode
    where the library row would run (as JAX's ``value_and_grad`` fails
    there)."""
    policy, par = model.policy, model.par
    routed = [why for why, on in (
        ("the policy fuses epilogues", policy.fuses()),
        ("use_pallas_attn routes attention into its kernels",
         par.use_pallas_attn),
        (f"isa mode {policy.mode!r} routes the norms into their kernels",
         policy.mode != "library")) if on]
    if routed:
        raise ValueError(
            "the port trains through the plain versions only (its kernels "
            "have no backward, as the JAX package's have none): "
            + "; ".join(routed))


def build_train_step(model, opt_cfg: OptConfig,
                     policy: Optional[ExecutionPolicy] = None):
    """-> (train_step, None), the JAX package's signature: the second
    element is where its sharding trees go, filled by the scale-out slice
    without changing a caller.  ``train_step(params, opt_state, batch) ->
    (params, opt_state, metrics)`` updates params and state in place and
    makes no host sync.  ``policy`` overrides the model's (resolved once,
    here).  The gradient compression is ``ParallelConfig.grad_compression``;
    ``opt_cfg.compression`` must name the same one (``ValueError``)."""
    if policy is not None:
        model = model.with_policy(policy)
    check_trainable(model)
    if opt_cfg.compression != model.par.grad_compression:
        raise ValueError(
            f"OptConfig(compression={opt_cfg.compression!r}) and "
            f"ParallelConfig(grad_compression="
            f"{model.par.grad_compression!r}) differ: set both")
    n_micro = model.par.grad_accum

    def grads_of(params, batch):
        flat = tree.flatten(params)
        leaves = list(flat.values())
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss, metrics = model.loss_fn(params, batch)
            # a leaf the loss does not reach gets zeros, as in JAX
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(flat.items(), grads)}
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                tree.unflatten(params, grads))

    def train_step(params, opt_state, batch):
        if n_micro > 1:
            # f32 sums, then / n (JAX's scan carry); .grad would sum in the
            # param dtype
            acc = tree.map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = 0.0
            micro_metrics = []
            for mb in _split_microbatches(batch, n_micro):
                mb_loss, mb_metrics, grads = grads_of(params, mb)
                tree.map(lambda a, g: a.add_(g), acc, grads)
                loss = loss + mb_loss
                micro_metrics.append(mb_metrics)
            grads = tree.map(lambda a: a.div_(n_micro), acc)
            loss = loss / n_micro
            metrics = {k: torch.stack([m[k] for m in micro_metrics]).mean()
                       for k in micro_metrics[0]}
        else:
            loss, metrics, grads = grads_of(params, batch)
        params, opt_state, stats = adamw_update(grads, opt_state, params,
                                                opt_cfg)
        return params, opt_state, dict(metrics, loss=loss, **stats)

    return train_step, None


def build_eval_step(model, policy: Optional[ExecutionPolicy] = None):
    """``eval_step(params, batch) -> metrics`` (with ``loss``), under
    ``torch.no_grad()``: any policy, kernels included."""
    if policy is not None:
        model = model.with_policy(policy)

    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = model.loss_fn(params, batch)
        return dict(metrics, loss=loss)
    return eval_step


def init_train_state(model, opt_cfg: OptConfig, seed: int = 0):
    """(params, opt_state) on the model's device."""
    params = model.init_params(seed)
    return params, init_opt_state(params, opt_cfg)
