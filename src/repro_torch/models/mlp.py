"""Feed-forward layers: the dense swiglu / gelu MLP and the GShard-style
mixture of experts (top-k routing with capacity truncation, dense
dispatch and combine einsums).  The expert products are plain PyTorch, as
the JAX package leaves them to XLA.  ``ctx`` moves the hidden activation,
the MoE's token groups and its expert buffers to their mesh layouts."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.models.config import LEGACY_LAYOUT, MoEConfig, ParamLayout
from repro_torch.parallel.sharding import shard


def init_mlp(generator, d: int, d_ff: int, act: str, dtype, device,
             layout: ParamLayout = LEGACY_LAYOUT):
    wi = common.dense_init(generator, (d, d_ff), 0, dtype, device)
    params = {"wo": common.dense_init(generator, (d_ff, d), 0, dtype, device)}
    if act == "silu":
        wg = common.dense_init(generator, (d, d_ff), 0, dtype, device)
        if layout.mlp_swiglu:
            params["wig"] = torch.cat([wi, wg], dim=1)
        else:
            params.update(wi=wi, wg=wg)
    else:
        params["wi"] = wi
    return params


def mlp_specs(act: str, layout: ParamLayout = LEGACY_LAYOUT):
    """The logical axes of :func:`init_mlp`'s leaves."""
    specs = {"wo": ("mlp", "embed")}
    if act == "silu" and layout.mlp_swiglu:
        specs["wig"] = ("embed", "mlp")
    elif act == "silu":
        specs.update(wi=("embed", "mlp"), wg=("embed", "mlp"))
    else:
        specs["wi"] = ("embed", "mlp")
    return specs


def _wi_wg(params):
    if "wig" in params:
        f = params["wig"].shape[-1] // 2
        return common.split_param(params, "wig", ("wi", "wg"), (f, f))
    return params["wi"], params["wg"]


def apply_mlp(params, x, act: str, policy=None, norm_scale=None,
              eps: float = 1e-6, ctx=None):
    """Position-wise MLP.  With ``norm_scale`` set, ``x`` is the raw
    residual and the pre-MLP rmsnorm rides into the projections (swiglu:
    one fused call against ``[wi|wg]`` with the gate in its epilogue; an
    int8 ``wig`` carries its ``wig_scale``).  The down projection stays a
    plain matmul, as in the JAX package."""
    if norm_scale is not None:
        if act == "silu":
            w_cat = common.concat_param(params, "wig", ("wi", "wg"))
            h = common.rmsnorm_swiglu(x, norm_scale, w_cat, eps,
                                      policy=policy,
                                      w_scale=params.get("wig_scale"))
        else:
            h = common.rmsnorm_matmul(x, norm_scale, params["wi"], eps,
                                      policy=policy)
            h = common.activation(h, act)
    elif act == "silu":
        if "wig_scale" in params:
            # the int8 concat on the unfused path: dequantized once, then
            # the per-matrix views
            params = dict(params, wig=common.dequantize_weight(
                params["wig"], params["wig_scale"], x.dtype))
        wi, wg = _wi_wg(params)
        h = torch.matmul(x, wi.to(x.dtype))
        gate = torch.matmul(x, wg.to(x.dtype))
        h = F.silu(gate) * h
    else:
        h = common.activation(torch.matmul(x, params["wi"].to(x.dtype)), act)
    h = shard(h, ("act_batch", "act_seq_unsharded", "act_mlp"), ctx)
    return torch.matmul(h, params["wo"].to(x.dtype))


# --------------------------------------------------------------------------
# Mixture of Experts
# --------------------------------------------------------------------------


def init_moe(generator, d: int, d_ff: int, moe: MoEConfig, act: str, dtype,
             device, layout: ParamLayout = LEGACY_LAYOUT):
    """Router ``[d, E]`` (f32), expert stacks ``wi``/``wg`` ``[E, d, d_ff]``
    and ``wo`` ``[E, d_ff, d]``, plus a shared dense MLP when the config
    has shared experts (it rides the layout plan; the routed stacks stay
    per matrix)."""
    e = moe.num_experts
    params = {
        "router": common.dense_init(generator, (d, e), 0, torch.float32,
                                    device),
        "wi": common.dense_init(generator, (e, d, d_ff), 1, dtype, device),
        "wg": common.dense_init(generator, (e, d, d_ff), 1, dtype, device),
        "wo": common.dense_init(generator, (e, d_ff, d), 1, dtype, device),
    }
    if moe.shared_experts:
        params["shared"] = init_mlp(generator, d, d_ff * moe.shared_experts,
                                    act, dtype, device, layout)
    return params


def moe_specs(moe: MoEConfig, act: str, layout: ParamLayout = LEGACY_LAYOUT):
    """The logical axes of :func:`init_moe`'s leaves."""
    specs = {
        "router": ("embed", None),
        "wi": ("experts", "embed", "expert_mlp"),
        "wg": ("experts", "embed", "expert_mlp"),
        "wo": ("experts", "expert_mlp", "embed"),
    }
    if moe.shared_experts:
        specs["shared"] = mlp_specs(act, layout)
    return specs


def _capacity(group_size: int, moe: MoEConfig) -> int:
    cap = int(group_size * moe.top_k * moe.capacity_factor / moe.num_experts)
    return max(8, ((cap + 7) // 8) * 8)


def _one_hot(index, n: int):
    """f32 one-hot by comparison with an ``arange``: an index outside
    ``[0, n)`` gives a zero row, and nothing is checked on the host."""
    return (index[..., None] == torch.arange(n, device=index.device)
            ).to(torch.float32)


def route(logits, moe: MoEConfig):
    """Top-k routing with capacity truncation.

    logits: [G, S, E] -> dispatch one-hot [G, S, E, C], combine weights
    [G, S, E, C] (f32) and the load-balance loss.  An assignment's place
    in its expert's buffer is the count of earlier assignments to that
    expert in token-major ``(token, k)`` order; places past the capacity
    are dropped.  Top-k is a stable descending sort, so among equal gates
    (zero-padded rows) the lower expert index comes first, as
    ``jax.lax.top_k`` orders them."""
    g, s, e = logits.shape
    k = moe.top_k
    c = _capacity(s, moe)
    gates = torch.softmax(logits.float(), dim=-1)
    top_w, top_ix = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_w, top_ix = top_w[..., :k], top_ix[..., :k]          # [G,S,K]
    if k > 1:
        top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    onehot = _one_hot(top_ix, e)                             # [G,S,K,E]
    flat = onehot.reshape(g, s * k, e)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(g, s, k, e)
    within = (pos * onehot).sum(dim=-1)                      # [G,S,K]
    keep = within < c
    w = top_w * keep
    cap_onehot = _one_hot(within.to(torch.int64), c)         # [G,S,K,C]
    dispatch = torch.einsum("gske,gskc->gsec", onehot * keep[..., None],
                            cap_onehot)
    combine = torch.einsum("gske,gskc->gsec", onehot * w[..., None],
                           cap_onehot)
    return dispatch, combine, _load_balance_loss(gates, onehot)


def _load_balance_loss(gates, onehot):
    """Switch-style auxiliary load-balancing loss."""
    me = gates.mean(dim=(0, 1))                              # [E]
    ce = onehot.sum(dim=2).mean(dim=(0, 1))                  # [E]
    return (me * ce).sum() * gates.shape[-1]


def apply_moe(params, x, moe: MoEConfig, act: str, policy=None,
              norm_scale=None, eps: float = 1e-6, ctx=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,S,D] -> (y, aux_loss).

    Tokens are routed in groups of ``min(group_size, tokens)``, the last
    zero-padded.  With ``norm_scale`` set, ``x`` is the raw residual: the
    router needs the normalized stream, computed here through the
    registry norm, while the shared expert fuses its own norm into
    ``[wi|wg]`` against the raw stream."""
    x_raw = x
    if norm_scale is not None:
        x = common.rmsnorm(x, norm_scale, eps, policy=policy)
    b, s, d = x.shape
    tokens = b * s
    gsz = min(moe.group_size, tokens)
    flat = x.reshape(tokens, d)
    pad = (-tokens) % gsz
    if pad:
        flat = F.pad(flat, (0, 0, 0, pad))
    xg = shard(flat.reshape(-1, gsz, d),
               ("act_group", "act_seq_unsharded", "act_embed"), ctx)
    logits = torch.einsum("gsd,de->gse", xg.float(), params["router"])
    dispatch, combine, aux = route(logits, moe)
    expert_in = torch.einsum("gsec,gsd->gecd", dispatch.to(x.dtype), xg)
    buffers = ("act_group", "act_experts", "act_capacity", "act_embed")
    expert_in = shard(expert_in, buffers, ctx)
    h = torch.einsum("gecd,edf->gecf", expert_in, params["wi"].to(x.dtype))
    gate = torch.einsum("gecd,edf->gecf", expert_in,
                        params["wg"].to(x.dtype))
    h = F.silu(gate) * h
    out = shard(torch.einsum("gecf,efd->gecd", h, params["wo"].to(x.dtype)),
                buffers, ctx)
    y = torch.einsum("gsec,gecd->gsd", combine.to(x.dtype), out)
    y = y.reshape(-1, d)[:tokens].reshape(b, s, d)
    if moe.shared_experts:
        if norm_scale is not None:
            y = y + apply_mlp(params["shared"], x_raw, act, policy=policy,
                              norm_scale=norm_scale, eps=eps, ctx=ctx)
        else:
            y = y + apply_mlp(params["shared"], x, act, ctx=ctx)
    return y, aux
