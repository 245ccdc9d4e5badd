"""The ranks of ``test_torch_sharded_prefill.py``: the port's prefill with
its parameters placed as DTensors on a ``(data=1, model=R)`` CPU mesh.

Run as ``python tests/_torch_sharded_ranks.py CASES.npz OUT.npz [RANKS]``
with ``src`` and ``tests`` on ``PYTHONPATH``: it starts RANKS (default 2)
gloo ranks through ``repro_torch.launch.hostdev`` and writes rank 0's
full logits of every case.  ``CASES.npz`` holds, for each case name ``n``,
``n/config`` and ``n/par`` (JSON of the ModelConfig fields to replace on
the reduced config, and of the ParallelConfig), ``n/tokens`` and
``n/param/<path>`` (the parameter leaves).  It imports no JAX."""
import dataclasses
import json
import sys

import numpy as np


def case_logits(name, arrays, ranks):
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import tree
    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import make_ctx, make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.config import ParallelConfig
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.parallel.sharding import (place_tree, sanitize_tree,
                                               tree_shardings)

    spec = json.loads(str(arrays[f"{name}/config"]))
    cfg = dataclasses.replace(get_reduced(spec.pop("arch")), **spec)
    par = ParallelConfig(**json.loads(str(arrays[f"{name}/par"])))
    prefix = f"{name}/param/"
    flat = {k[len(prefix):]: arrays[k] for k in arrays if k.startswith(prefix)}
    mesh = make_mesh((1, ranks), ("data", "model"), device_type="cpu")
    ctx = make_ctx(mesh, par, cfg)
    model = build_model(cfg, par, device="cpu", ctx=ctx)
    nested = {}
    for path, leaf in flat.items():
        *keys, last = path.split("/")
        node = nested
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = leaf
    params = params_from_numpy(nested, "cpu")
    shardings = sanitize_tree(tree_shardings(ctx, model.param_specs()),
                              params)
    placed = place_tree(params, shardings)
    tokens = torch.from_numpy(arrays[f"{name}/tokens"])
    with torch.no_grad(), implicit_replication():
        logits, _ = model.prefill(placed, {"tokens": tokens})
    sharded = sum(any(p.is_shard() for p in leaf.placements)
                  for leaf in tree.leaves(placed))
    return logits.full_tensor().numpy(), sharded, ctx.qkv_heads_shardable


def run_cases(path, ranks):
    arrays = dict(np.load(path))
    names = sorted({k.split("/")[0] for k in arrays})
    out = {}
    for name in names:
        logits, sharded, qkv = case_logits(name, arrays, ranks)
        out[f"{name}/logits"] = logits
        out[f"{name}/sharded_leaves"] = np.int64(sharded)
        out[f"{name}/qkv_shardable"] = np.bool_(qkv)
    return out


def main(argv):
    from repro_torch.launch import hostdev
    src, dst = argv[1], argv[2]
    ranks = int(argv[3]) if len(argv) > 3 else 2
    out = hostdev.run_host_ranks(run_cases, src, ranks, count=ranks,
                                 timeout=150)
    np.savez(dst, **out)


if __name__ == "__main__":
    main(sys.argv)
