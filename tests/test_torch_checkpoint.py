"""Checkpoints across the two packages, on the CPU, and the port's
fault-tolerant loop.

- A checkpoint the JAX package writes (the tiny model's ``{params,
  opt_state}`` in f32, in bf16, in the legacy and the concat layouts, and
  in int8 through ``migrate_to``) restores into the port bit for bit; bf16
  is held to the arrays JAX saved (JAX itself cannot restore them: its
  ``np.load`` gives void bytes it cannot cast).
- One the port writes restores into the JAX package bit for bit; the two
  packages' manifests are equal but for ``time`` and their ``.npy`` files
  byte for byte, bf16 included.
- ``quantize_leaf`` and ``migrate_layout`` equal JAX's both ways, and
  requantization is stable.
- tests/test_substrate.py's checkpoint and loop tests on the port, a stray
  ``.tmp``, the async error on ``wait()``, a params-only restore,
  ``resume_or_init``, a preempted-then-resumed ``train_loop`` equal to an
  uninterrupted one bit for bit, and the launcher's resume.
- The train-to-serve handoff: the port trains in the legacy layout and
  saves; both packages restore into a fused-policy (concat) model and
  serve; the tokens are equal."""
import dataclasses
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefManager
from repro.checkpoint import manager as ref_manager
from repro.models import build_model as ref_build
from repro.models import common as ref_common
from repro.models.config import ParallelConfig as RefPar
from repro.serve import BatchedEngine as RefEngine
from repro.serve import Request as RefRequest
from repro.serve import ServeConfig as RefServe
from repro.train import optim as ref_optim
from test_serve_equivalence import tiny_model

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import manager
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model, common
from repro_torch.models.config import ModelConfig, ParallelConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import BatchedEngine, Request, ServeConfig
from repro_torch.train import OptConfig, build_train_step, init_opt_state
from repro_torch.train.loop import (LoopConfig, PreemptionGuard,
                                    StragglerMonitor, resume_or_init,
                                    train_loop)
from repro_torch.tree import flatten

KEY = jax.random.PRNGKey(7)
FUSED = dict(fuse_epilogues=True, use_pallas_attn=True)


def _cfgs(dtype="float32"):
    ref_cfg = dataclasses.replace(tiny_model()[1], dtype=dtype)
    return ref_cfg, ModelConfig(**dataclasses.asdict(ref_cfg))


def _ref_tree(dtype="float32", layout="legacy"):
    """The JAX tiny model's {params, opt_state} (after one update, so no
    leaf is all zeros)."""
    ref_cfg, _ = _cfgs(dtype)
    model = ref_build(ref_cfg, RefPar(remat="none", **(
        dict(fuse_epilogues=True) if layout == "concat" else {})))
    params = model.init_params(KEY)
    opt = ref_optim.OptConfig(warmup_steps=1)
    state = ref_optim.init_opt_state(params, opt)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.25, p.dtype), params)
    params, state, _ = ref_optim.adamw_update(grads, state, params, opt)
    return {"params": params, "opt_state": state}


def _port_template(dtype="float32", layout="legacy", int8=False):
    _, cfg = _cfgs(dtype)
    model = build_model(cfg, ParallelConfig(**(
        FUSED if layout == "concat" else {})), device="cpu")
    params = model.init_params(0)
    if int8:
        params = common.quantize_params(params)
    return {"params": params, "opt_state": init_opt_state(params,
                                                          OptConfig())}


def _bits(x) -> np.ndarray:
    """A leaf's bytes as an unsigned-integer array (bf16 by its bits)."""
    if isinstance(x, torch.Tensor):
        x = manager.to_host(x)
    x = np.asarray(x)
    return x.view(np.dtype(f"u{x.dtype.itemsize}"))


def _assert_bitwise(got_tree, want_tree):
    got, want = flatten(got_tree), flatten(want_tree)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(np.shape(w)), k
        assert np.array_equal(_bits(got[k]), _bits(w)), k


# --------------------------------------------------------------------------
# JAX writes, the port restores
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,layout", [("float32", "legacy"),
                                          ("float32", "concat"),
                                          ("bfloat16", "legacy"),
                                          ("bfloat16", "concat")])
def test_port_restores_reference_checkpoint(tmp_path, dtype, layout):
    tree = _ref_tree(dtype, layout)
    RefManager(str(tmp_path)).save(3, tree, extra={"note": "jax"})
    ck = CheckpointManager(str(tmp_path))
    assert ck.latest_step() == 3
    assert ck.manifest(3)["param_layout"] == layout
    got = ck.restore(3, _port_template(dtype, layout))
    _assert_bitwise(got, jax.tree.map(np.asarray, tree))
    got_params = flatten(got["params"])
    assert got_params["blocks/ln1/scale"].dtype == getattr(torch, dtype)
    assert got["opt_state"]["step"].dtype == torch.int32
    if dtype == "bfloat16":
        # fact 3: the reference's own restore of its bf16 leaves fails
        with pytest.raises(ValueError):
            RefManager(str(tmp_path)).restore(3, tree)


def test_port_restores_reference_checkpoint_across_layouts(tmp_path):
    """A legacy checkpoint into a concat template and back, each equal to
    the JAX package's own migration."""
    legacy = _ref_tree()["params"]
    ref_ck = RefManager(str(tmp_path))
    ref_ck.save(0, legacy)
    _, fused = (ref_build(_cfgs()[0], RefPar(remat="none", **kw))
                for kw in ({}, dict(fuse_epilogues=True)))
    want = ref_ck.restore(0, jax.eval_shape(fused.init_params, KEY))
    ck = CheckpointManager(str(tmp_path))
    got = ck.restore(0, _port_template(layout="concat")["params"])
    _assert_bitwise(got, jax.tree.map(np.asarray, want))
    ck.save(1, got)
    assert ck.manifest(1)["param_layout"] == "concat"
    back = ck.restore(1, _port_template()["params"])
    _assert_bitwise(back, jax.tree.map(np.asarray, legacy))


def test_port_restores_reference_int8_checkpoint(tmp_path):
    tree = _ref_tree(layout="concat")
    params = tree["params"]
    qtmpl = jax.eval_shape(lambda: ref_common.quantize_params(params))
    ref_ck = RefManager(str(tmp_path), keep=5)
    ref_ck.save(0, params, migrate_to=qtmpl)
    assert ref_ck.manifest(0)["precision"] == "int8"
    ck = CheckpointManager(str(tmp_path))
    # int8 into an int8 template: the saved bytes and scales
    q = ck.restore(0, _port_template(layout="concat", int8=True)["params"])
    _assert_bitwise(q, jax.tree.map(np.asarray, ref_ck.restore(0, qtmpl)))
    assert flatten(q)["blocks/attn/wqkv"].dtype == torch.int8
    # int8 into f32 templates: dequantized as JAX dequantizes, either layout
    for layout, kw in (("concat", dict(fuse_epilogues=True)),
                       ("legacy", {})):
        ref_tmpl = jax.eval_shape(ref_build(_cfgs()[0], RefPar(
            remat="none", **kw)).init_params, KEY)
        got = ck.restore(0, _port_template(layout=layout)["params"])
        _assert_bitwise(got, jax.tree.map(np.asarray,
                                          ref_ck.restore(0, ref_tmpl)))


# --------------------------------------------------------------------------
# the port writes, JAX restores; the files are JAX's
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_writes_the_reference_files(tmp_path, dtype):
    tree = _ref_tree(dtype)
    port_tree = {"params": params_from_numpy(
        jax.tree.map(np.asarray, tree["params"]), "cpu"),
        "opt_state": params_from_numpy(
            jax.tree.map(np.asarray, tree["opt_state"]), "cpu")}
    extra = {"data": {"step": 5, "seed": 0}}
    RefManager(str(tmp_path / "jax")).save(5, tree, extra=extra)
    CheckpointManager(str(tmp_path / "port")).save(5, port_tree, extra=extra)
    jdir, pdir = (tmp_path / w / "step_00000005" for w in ("jax", "port"))
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(pdir))
    for name in names:
        if name == "manifest.json":
            continue
        assert filecmp.cmp(jdir / name, pdir / name, shallow=False), name
    want = RefManager(str(tmp_path / "jax")).manifest(5)
    got = CheckpointManager(str(tmp_path / "port")).manifest(5)
    want.pop("time"), got.pop("time")
    assert got == want
    for name in names:
        if name != "manifest.json":
            arr = np.load(pdir / name)
            leaf = got["leaves"][name[:-4].replace("__", "/")]
            assert list(arr.shape) == leaf["shape"]
            assert (leaf["dtype"] == "bfloat16" and arr.dtype.str == "|V2") \
                or str(arr.dtype) == leaf["dtype"]
    if dtype == "float32":
        restored = RefManager(str(tmp_path / "port")).restore(5, tree)
        _assert_bitwise(restored, jax.tree.map(np.asarray, tree))


def test_quantize_leaf_and_migrate_layout_equal_reference():
    rng = np.random.default_rng(0)
    for shape in ((16, 24), (2, 16, 24)):
        a = rng.standard_normal(shape).astype(np.float32) * 3
        q, s = manager.quantize_leaf(a)
        rq, rs = ref_manager.quantize_leaf(a)
        assert np.array_equal(q, rq) and s.tobytes() == rs.tobytes()
        d = manager.dequantize_leaf(q, s)
        assert d.tobytes() == ref_manager.dequantize_leaf(rq, rs).tobytes()
        # requantization is a fixed point
        q2, s2 = manager.quantize_leaf(d)
        assert np.array_equal(q2, q) and s2.tobytes() == s.tobytes()
    import ml_dtypes
    b = rng.standard_normal((8, 4)).astype(ml_dtypes.bfloat16)
    q, s = manager.quantize_leaf(b.view(manager.BF16))
    rq, rs = ref_manager.quantize_leaf(b)
    assert np.array_equal(q, rq) and s.tobytes() == rs.tobytes()
    got = manager.dequantize_leaf(q, s, torch.bfloat16)
    want = ref_manager.dequantize_leaf(rq, rs, ml_dtypes.bfloat16)
    assert got.tobytes() == want.tobytes()
    # both directions of the layout, and precision down and up
    flat = {"blocks/attn/wq": rng.standard_normal((2, 8, 8)),
            "blocks/attn/wk": rng.standard_normal((2, 8, 4)),
            "blocks/attn/wv": rng.standard_normal((2, 8, 4)),
            "blocks/mlp/wig": rng.standard_normal((2, 8, 12)),
            "embed": rng.standard_normal((5, 8))}
    flat = {k: v.astype(np.float32) for k, v in flat.items()}
    shapes = {"blocks/attn/wqkv": (2, 8, 16), "blocks/mlp/wi": (2, 8, 6),
              "blocks/mlp/wg": (2, 8, 6), "embed": (5, 8),
              "blocks/attn/wqkv_scale": (2, 16)}
    dtypes = {"blocks/attn/wqkv": np.int8, "blocks/mlp/wi": np.float32,
              "blocks/mlp/wg": np.float32, "embed": np.float32,
              "blocks/attn/wqkv_scale": np.float32}
    for sh, dt in ((shapes, None), (shapes, dtypes)):
        got = manager.migrate_layout(flat, sh, dt)
        want = ref_manager.migrate_layout(flat, sh, dt)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k
    back_shapes = {k: v.shape for k, v in flat.items()}
    up = manager.migrate_layout(flat, shapes, dtypes)
    down = manager.migrate_layout(up, back_shapes, {k: np.float32
                                                    for k in back_shapes})
    want = ref_manager.migrate_layout(ref_manager.migrate_layout(
        flat, shapes, dtypes), back_shapes, {k: np.float32
                                             for k in back_shapes})
    for k in want:
        assert np.array_equal(down[k], want[k]), k
    with pytest.raises(ValueError):
        manager.migrate_layout({"blocks/attn/wqkv": np.zeros((4, 10))},
                               {"blocks/attn/wq": (4, 4),
                                "blocks/attn/wk": (4, 4),
                                "blocks/attn/wv": (4, 4)})
    assert manager.layout_of(["blocks/attn/wq", "embed"]) == "legacy"
    assert manager.layout_of(["blocks/mlp/wig"]) == "concat"


# --------------------------------------------------------------------------
# tests/test_substrate.py's checkpoint tests and the manager's edges
# --------------------------------------------------------------------------


class TestCheckpoint:
    def _tree(self, x=1.0):
        return {"params": {"w": torch.full((4, 4), x),
                           "b": torch.zeros(4)},
                "opt_state": {"step": torch.tensor(3, dtype=torch.int32)}}

    def test_roundtrip(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(10, self._tree(2.5))
        got = mgr.restore(10, self._tree(0.0))
        assert torch.equal(got["params"]["w"], torch.full((4, 4), 2.5))
        assert mgr.latest_step() == 10

    def test_atomic_no_tmp_visible_and_stray_tmp_ignored(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, self._tree())
        assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]
        os.makedirs(tmp_path / "step_00000009.tmp")    # a save cut short
        assert mgr.all_steps() == [1] and mgr.latest_step() == 1

    def test_retention(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2, keep_period=10)
        for s in (5, 10, 15, 20, 25):
            mgr.save(s, self._tree())
        assert mgr.all_steps() == [10, 20, 25]

    def test_async_save_lands_after_wait(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        tree = self._tree(1.5)
        mgr.save(7, tree, blocking=False)
        tree["params"]["w"].fill_(9.0)        # the host copy was taken
        mgr.wait()
        assert mgr.latest_step() == 7
        assert float(mgr.restore(7, self._tree())["params"]["w"][0, 0]) == 1.5

    def test_async_error_is_raised_by_wait(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))

        def fail(*args):
            raise OSError("disk gone")
        mgr._write = fail
        mgr.save(1, self._tree(), blocking=False)
        with pytest.raises(OSError, match="disk gone"):
            mgr.wait()
        mgr.wait()                                # raised once

    def test_restore_missing_leaf_raises(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, {"a": torch.zeros(2)})
        with pytest.raises((KeyError, FileNotFoundError)):
            mgr.restore(1, {"a": torch.zeros(2), "b": torch.zeros(2)})

    def test_manifest_describes_leaves(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(2, self._tree(), extra={"note": "hi"})
        man = mgr.manifest(2)
        assert man["extra"]["note"] == "hi"
        assert man["leaves"]["params/w"] == {"shape": [4, 4],
                                             "dtype": "float32"}
        assert man["leaves"]["opt_state/step"] == {"shape": [],
                                                   "dtype": "int32"}

    def test_params_only_restore_reads_no_opt_state(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        tree = _port_template()
        mgr.save(4, tree)
        d = tmp_path / "step_00000004"
        for name in os.listdir(d):
            if name.startswith("opt_state__"):
                os.remove(d / name)              # never read
        got = mgr.restore(4, {"params": _port_template()["params"]})
        _assert_bitwise(got, {"params": tree["params"]})
        got = mgr.restore(4, {"params": tree["params"]}, device="cpu")
        assert flatten(got)["params/embed"].device.type == "cpu"


# --------------------------------------------------------------------------
# the loop
# --------------------------------------------------------------------------


def _loop_setup(total=6):
    _, cfg = _cfgs()
    model = build_model(cfg, ParallelConfig(remat="none"), device="cpu")
    opt_cfg = OptConfig(total_steps=total, warmup_steps=1)
    step_fn, _ = build_train_step(model, opt_cfg)

    def init_fn():
        params = model.init_params(0)
        return params, init_opt_state(params, opt_cfg)
    ds = SyntheticLMDataset(DataConfig(global_batch=4, seq_len=16,
                                       vocab_size=cfg.vocab_size))

    def put(batch):
        return {k: torch.from_numpy(v) for k, v in batch.items()}
    return model, step_fn, init_fn, ds, put


class TestTrainLoop:
    def test_checkpoint_restart_continuity(self, tmp_path):
        _, step_fn, init_fn, ds, put = _loop_setup()
        ckpt = CheckpointManager(str(tmp_path))
        params, opt = init_fn()
        p1, o1, rep = train_loop(step_fn, params, opt, ds,
                                 LoopConfig(total_steps=4, checkpoint_every=2,
                                            async_checkpoint=False),
                                 ckpt, batch_put=put)
        assert rep["final_step"] == 4
        p2, o2, start = resume_or_init(ckpt, init_fn)
        assert start == 4
        _assert_bitwise({"p": p2, "o": o2}, {"p": p1, "o": o1})
        assert resume_or_init(None, init_fn)[2] == 0

    def test_preempted_then_resumed_equals_uninterrupted(self, tmp_path):
        _, step_fn, init_fn, ds, put = _loop_setup()
        loop = LoopConfig(total_steps=6, checkpoint_every=100, log_every=1)
        params, opt = init_fn()
        want_p, want_o, want = train_loop(step_fn, params, opt, ds, loop,
                                          None, batch_put=put)
        guard = PreemptionGuard(install=False)
        ckpt = CheckpointManager(str(tmp_path))

        def sink(step, rec):
            if step == 2:
                guard.requested = True          # SIGTERM during step 2
        params, opt = init_fn()
        _, _, rep = train_loop(step_fn, params, opt, ds, loop, ckpt,
                               metrics_sink=sink, preemption=guard,
                               batch_put=put)
        assert rep["preempted"] and rep["final_step"] == 3
        assert ckpt.manifest(3)["extra"]["preempted"] is True
        params, opt, start = resume_or_init(ckpt, init_fn)
        assert start == 3
        got_p, got_o, rep2 = train_loop(step_fn, params, opt, ds, loop,
                                        ckpt, start_step=start,
                                        batch_put=put)
        assert rep2["final_step"] == 6 and not rep2["preempted"]
        _assert_bitwise({"p": got_p, "o": got_o}, {"p": want_p, "o": want_o})
        losses = [h["loss"] for h in rep["history"] + rep2["history"]]
        assert losses == [h["loss"] for h in want["history"]]

    def test_straggler_detection(self):
        mon = StragglerMonitor(factor=2.0, alpha=0.5)
        for _ in range(5):
            mon.observe(0, 0.1)
        assert mon.observe(10, 0.5)
        assert len(mon.events) == 1 and mon.events[0]["slowdown"] > 2.0

    def test_loss_decreases(self):
        _, step_fn, init_fn, ds, put = _loop_setup(total=12)
        params, opt = init_fn()
        _, _, rep = train_loop(step_fn, params, opt, ds,
                               LoopConfig(total_steps=12,
                                          checkpoint_every=1000,
                                          log_every=1), None, batch_put=put)
        losses = [h["loss"] for h in rep["history"]]
        assert losses[-1] < losses[0]

    def test_launcher_resumes_from_its_checkpoint(self, tmp_path, capsys):
        argv = ["--arch", "granite-8b", "--reduced", "--steps", "4",
                "--ckpt-every", "2", "--ckpt-dir", str(tmp_path),
                "--batch", "2", "--seq", "16", "--device", "cpu",
                "--log-every", "1"]
        first = launch_train.main(argv)
        assert first["final_step"] == 4
        argv[argv.index("--steps") + 1] = "6"
        second = launch_train.main(argv)
        assert "resumed from checkpoint at step 4" in capsys.readouterr().out
        assert second["final_step"] == 6
        assert [h["step"] for h in second["history"]] == [4, 5]
        with pytest.raises(SystemExit, match="A.8"):
            launch_train.main(argv + ["--mesh", "2x1"])


# --------------------------------------------------------------------------
# train in the port, serve from the checkpoint in both packages
# --------------------------------------------------------------------------


def test_train_to_serve_handoff(tmp_path):
    ref_cfg, cfg = _cfgs()
    model, step_fn, init_fn, ds, put = _loop_setup(total=3)
    params, opt = init_fn()
    ckpt = CheckpointManager(str(tmp_path))
    train_loop(step_fn, params, opt, ds,
               LoopConfig(total_steps=3, checkpoint_every=3,
                          async_checkpoint=False), ckpt, batch_put=put,
               save_extra={"param_layout": dataclasses.asdict(
                   model.param_layout)})
    assert ckpt.manifest(3)["param_layout"] == "legacy"
    fused = build_model(cfg, ParallelConfig(**FUSED), device="cpu")
    params = ckpt.restore(3, {"params": fused.init_params(0)})["params"]
    assert "wqkv" in params["blocks"]["attn"]
    ref = ref_build(ref_cfg, RefPar(remat="none", **FUSED))
    ref_params = RefManager(str(tmp_path)).restore(
        3, {"params": jax.eval_shape(ref.init_params, KEY)})["params"]
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(2, cfg.vocab_size, 4 + i)]
               for i in range(3)]
    serve = dict(batch_slots=2, max_seq_len=32, eos_id=-1)
    want = RefEngine(ref, ref_params, RefServe(**serve)).run(
        [RefRequest(rid=i, prompt=p, max_new_tokens=5)
         for i, p in enumerate(prompts)])
    got = BatchedEngine(fused, params, ServeConfig(**serve)).run(
        [Request(rid=i, prompt=p, max_new_tokens=5)
         for i, p in enumerate(prompts)])
    assert {r.rid: r.generated for r in got} == \
        {r.rid: r.generated for r in want}
    assert all(len(r.generated) == 5 for r in got)
