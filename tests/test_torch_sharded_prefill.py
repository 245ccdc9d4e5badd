"""The port's prefill on two gloo ranks: the reduced granite-8b's
parameters placed as DTensors on a ``(data=1, model=2)`` CPU mesh by
``tree_shardings(make_ctx(mesh, par, cfg), model.param_specs())``,
sanitized, the prefill run inside ``implicit_replication()``; its logits
equal the one-process port's and the JAX package's at ``TOLERANCES[None]``.

Cases: heads that divide the model axis (4 / 2) and heads that do not
(6 / 3: the fused layout's [wq|wk|wv] then replicates), each under the
default policy and the fused layout; and the fused layout with the
activations seq-sharded, ``rs_outputs`` and ``constrain_kv_pre_repeat``
off.  One subprocess
(``tests/_torch_sharded_ranks.py``) starts the ranks through
``repro_torch.launch.hostdev``."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import torch

from conftest import TOLERANCES
from repro.configs import get_reduced as ref_reduced
from repro.models import build_model as ref_build
from repro.models.config import ParallelConfig as RefPar

from repro_torch import tree
from repro_torch.configs import get_reduced
from repro_torch.models import build_model
from repro_torch.models.config import ParallelConfig
from repro_torch.models.convert import params_from_numpy

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
#: case -> (config fields replaced on the reduced granite-8b, policy)
CASES = {
    "divisible_default": ({}, {}),
    "divisible_fused": ({}, dict(fuse_epilogues=True)),
    "odd_default": (dict(num_heads=6, num_kv_heads=3, head_dim=16), {}),
    "odd_fused": (dict(num_heads=6, num_kv_heads=3, head_dim=16),
                  dict(fuse_epilogues=True)),
    # the outputs moved to the seq-sharded residual, k/v left unconstrained
    "divisible_rs": ({}, dict(fuse_epilogues=True, seq_shard_acts=True,
                              rs_outputs=True,
                              constrain_kv_pre_repeat=False)),
}


def test_two_rank_prefill_equals_one_process(tmp_path):
    arrays, want = {}, {}
    rng = np.random.default_rng(0)
    for name, (fields, par_kw) in CASES.items():
        ref_cfg = dataclasses.replace(ref_reduced("granite-8b"), **fields)
        ref = ref_build(ref_cfg, RefPar(**par_kw))
        ref_params = jax.tree.map(np.asarray,
                                  ref.init_params(jax.random.PRNGKey(1)))
        tokens = rng.integers(0, ref_cfg.vocab_size, (2, 12)).astype(np.int32)
        ref_logits, _ = ref.prefill(ref_params, {"tokens": tokens})
        cfg = dataclasses.replace(get_reduced("granite-8b"), **fields)
        model = build_model(cfg, ParallelConfig(**par_kw), device="cpu")
        params = params_from_numpy(ref_params, "cpu")
        with torch.no_grad():
            one, _ = model.prefill(params, {"tokens": torch.from_numpy(
                tokens.astype(np.int64))})
        want[name] = (np.asarray(ref_logits), one.numpy())
        arrays[f"{name}/config"] = json.dumps(dict(fields, arch="granite-8b"))
        arrays[f"{name}/par"] = json.dumps(par_kw)
        arrays[f"{name}/tokens"] = tokens.astype(np.int64)
        for path, leaf in tree.flatten(ref_params).items():
            arrays[f"{name}/param/{path}"] = leaf
    src, dst = tmp_path / "cases.npz", tmp_path / "out.npz"
    np.savez(src, **arrays)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), TESTS]))
    proc = subprocess.run(
        [sys.executable, os.path.join(TESTS, "_torch_sharded_ranks.py"),
         str(src), str(dst), "2"], env=env, cwd=tmp_path,
        capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = dict(np.load(dst))
    tol = TOLERANCES[None]
    for name in CASES:
        ref_logits, one = want[name]
        logits = got[f"{name}/logits"]
        assert logits.shape == (2, get_reduced("granite-8b").vocab_size)
        np.testing.assert_allclose(logits, one, **tol, err_msg=name)
        np.testing.assert_allclose(logits, ref_logits, **tol, err_msg=name)
        assert got[f"{name}/sharded_leaves"] > 0, name
    assert bool(got["divisible_fused/qkv_shardable"])
    assert not bool(got["odd_fused/qkv_shardable"])
