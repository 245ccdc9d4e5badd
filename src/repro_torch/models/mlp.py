"""Feed-forward layers: the dense swiglu / gelu MLP.  The mixture-of-experts
layers of the JAX package come with their slice (ROADMAP A.12)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.models.config import LEGACY_LAYOUT, ParamLayout


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


def _wi_wg(params):
    if "wig" in params:
        f = params["wig"].shape[-1] // 2
        return common.split_param(params, "wig", ("wi", "wg"), (f, f))
    return params["wi"], params["wg"]


def apply_mlp(params, x, act: str, policy=None, norm_scale=None,
              eps: float = 1e-6):
    """Position-wise MLP.  With ``norm_scale`` set, ``x`` is the raw
    residual and the pre-MLP rmsnorm rides into the projections (swiglu:
    one fused call against ``[wi|wg]`` with the gate in its epilogue).
    The down projection stays a plain matmul, as in the JAX package."""
    if norm_scale is not None:
        if act == "silu":
            w_cat = common.concat_param(params, "wig", ("wi", "wg"))
            h = common.rmsnorm_swiglu(x, norm_scale, w_cat, eps,
                                      policy=policy)
        else:
            h = common.rmsnorm_matmul(x, norm_scale, params["wi"], eps,
                                      policy=policy)
            h = common.activation(h, act)
    elif act == "silu":
        wi, wg = _wi_wg(params)
        h = torch.matmul(x, wi.to(x.dtype))
        gate = torch.matmul(x, wg.to(x.dtype))
        h = F.silu(gate) * h
    else:
        h = common.activation(torch.matmul(x, params["wi"].to(x.dtype)), act)
    return torch.matmul(h, params["wo"].to(x.dtype))
