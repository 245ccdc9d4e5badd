"""``mode="auto"`` in the port: the picks against the JAX package's, the
port's own picks on Hopper pinned, the library escape (CPU operands only),
the selection memo, ``ssd_scan(chunk=None)``, and the engine's tokens
against the JAX engine's under ``isa_mode="auto"``.

At the JAX package's compile target (``target=TPU_V5E``) the port's
ranking picks what the JAX ``select`` picks.  At its own target the port
ranks Hopper's costs; the GEMM-shaped fused ops then pick ``native`` on
Hopper (the modelled native tile, (256, 1024, 32), streams the fewest
bytes), and everything else the more portable of the zero-scratch
budgets."""
import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

from conftest import tolerance_for
from repro.core import ExecutionPolicy as RefPolicy
from repro.core import REGISTRY as REF_REGISTRY
from repro.kernels import ops as ref_ops
from repro.models import build_model as ref_build
from repro.models.config import ParallelConfig as RefPar
from test_serve_equivalence import tiny_model
from test_torch_engine import _prompts, _run_both, _tokens
from test_torch_ssd import _close, _j, _scan_inputs, _t

from repro.configs import get_reduced as ref_reduced
from repro_torch.core import (DIALECTS, REGISTRY, TARGET, TPU_V5E,
                              ExecutionPolicy, IsaMode, KernelContract,
                              LoweringFallbackWarning, LoweringRegistry,
                              Primitive, UnsupportedLowering)
from repro_torch.kernels import fused, ops, ssd
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig, ParallelConfig, \
    ParamLayout
from repro_torch.models.convert import params_from_numpy

ACCUM = tolerance_for("f32_accum")
NAMES = sorted(DIALECTS)
#: the five dialects where native is illegal in both packages
FOREIGN = ["amd-rdna3", "apple-g13", "intel-xe-hpg", "nvidia-ada-sm89",
           "uisa-universal10"]

#: the served shapes: granite-8b (8 slots, prompts to 512, pages of 128
#: over 576 positions), mamba2-2.7b, and Table V at the paper's sizes
SERVED = {
    "qkv decode": ("rmsnorm_matmul", dict(rows=8, d=4096, n=6144)),
    "qkv prefill": ("rmsnorm_matmul", dict(rows=512, d=4096, n=6144)),
    "head prefill": ("rmsnorm_matmul", dict(rows=1, d=4096, n=49152)),
    "head decode": ("rmsnorm_matmul", dict(rows=8, d=4096, n=49152)),
    "swiglu decode": ("rmsnorm_swiglu", dict(rows=8, d=4096, f=14336)),
    "swiglu prefill": ("rmsnorm_swiglu", dict(rows=512, d=4096, f=14336)),
    "attention prefill": ("flash_attention_matmul", dict(
        b=1, h=32, sq=512, skv=512, d=128, n=4096, causal=True,
        block_q=None, block_kv=None)),
    "attention paged": ("flash_attention_matmul", dict(
        b=8, h=32, sq=1, skv=640, d=128, n=4096, causal=False,
        block_q=None, block_kv=128, page_size=128, pages_occupied=40)),
    "qkv decode q8": ("rmsnorm_matmul_q8", dict(rows=8, d=4096, n=6144)),
    "swiglu prefill q8": ("rmsnorm_swiglu_q8",
                          dict(rows=512, d=4096, f=14336)),
    "attention paged q8": ("flash_attention_matmul_q8", dict(
        b=8, h=32, sq=1, skv=640, d=128, n=4096, causal=False,
        block_q=None, block_kv=128, page_size=128, pages_occupied=40)),
    "add_rmsnorm": ("add_rmsnorm", dict(rows=512, d=1536)),
    "mamba norm": ("rmsnorm", dict(rows=512, d=2560)),
    "mamba gated norm": ("rmsnorm", dict(rows=8, d=5120)),
    "ssd_scan": ("ssd_scan", dict(b=1, seq=512, h=80, p=64, g=1, n=128,
                                  chunk=256)),
    "ssd_decode": ("ssd_decode", dict(b=8, h=80, p=64, g=1, n=128,
                                      block_b=None)),
    "flash_attention": ("flash_attention", dict(
        b=1, h=32, sq=512, skv=512, d=128, causal=True, block_q=None,
        block_kv=None)),
    "gemm 4096": ("gemm", dict(m=4096, n=4096, k=4096)),
    "reduction 2^24": ("reduction", dict(n=1 << 24)),
    "histogram 2^24": ("histogram", dict(n=1 << 24, num_bins=256)),
}
#: the GEMM-shaped fused ops, which pick native on Hopper
GEMM_SHAPED = ("rmsnorm_matmul", "rmsnorm_swiglu", "flash_attention_matmul",
               "rmsnorm_matmul_q8", "rmsnorm_swiglu_q8",
               "flash_attention_matmul_q8", "gemm")


def hopper_pick(op: str, dialect: str) -> str:
    """The port's pinned auto pick of ``op`` at the served shapes."""
    if dialect == "uisa-universal10":
        return "abstract"
    if op in GEMM_SHAPED and dialect == TARGET.name:
        return "native"
    return "abstract" if op == "gemm" else "abstract+shuffle"


@pytest.mark.parametrize("label", sorted(SERVED))
def test_ranking_at_the_jax_target_is_the_jax_pick(label):
    op, shape = SERVED[label]
    for name in FOREIGN + ["tpu-v5e"]:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = REF_REGISTRY.select(op, RefPolicy(mode="auto",
                                                     dialect=name),
                                       shape=shape).mode.value
        got = REGISTRY.ranked(op, DIALECTS[name], shape, target=TPU_V5E)
        assert got[0].mode.value == want, (label, name)


@pytest.mark.parametrize("label", sorted(SERVED))
def test_hopper_picks_are_pinned(label):
    op, shape = SERVED[label]
    for name in NAMES:
        low = REGISTRY.select(op, ExecutionPolicy(mode="auto", dialect=name),
                              shape=shape, device=torch.device("cpu"))
        assert low.op == op
        assert low.mode.value == hopper_pick(op, name), (label, name)
        if name in FOREIGN:        # where native is illegal in both
            assert low.mode.value == REF_REGISTRY.select(
                op, RefPolicy(mode="auto", dialect=name),
                shape=shape).mode.value


@pytest.mark.parametrize("name", NAMES)
def test_auto_resolves_every_registered_op(name):
    pol = ExecutionPolicy(mode="auto", dialect=name)
    for op in REGISTRY.ops():
        low = REGISTRY.select(op, pol, shape=ops.PROBE_SHAPES[op],
                              device=torch.device("cuda"))
        assert low.mode is not IsaMode.LIBRARY
        assert REGISTRY.legal(op, low.mode, DIALECTS[name]), (op, name)


def test_precision_retargets_under_auto():
    pol = ExecutionPolicy(mode="auto", precision="int8")
    low = REGISTRY.select("rmsnorm_matmul", pol,
                          shape=dict(rows=8, d=4096, n=6144))
    assert low.op == "rmsnorm_matmul_q8" and low.mode is IsaMode.NATIVE


# ---------------------------------------------------------------------------
# The library escape and the memo, on a registry of their own
# ---------------------------------------------------------------------------


def _shuffle_only(reg, op="scratch_op"):
    contract = KernelContract(
        kernel=op, mode=IsaMode.ABSTRACT_SHUFFLE,
        primitives=frozenset({Primitive.LOCKSTEP_GROUP,
                              Primitive.LANE_SHUFFLE}))
    reg.register(op, IsaMode.ABSTRACT_SHUFFLE, lambda x: ("shuffle", x),
                 contract=contract, cost=lambda **shape: {})
    reg.register(op, IsaMode.LIBRARY, lambda x: ("library", x))
    return op


def test_library_escape_on_cpu_only():
    """An op with only a shuffle kernel has no legal kernel lowering on
    uisa-universal10: auto takes the library row for CPU operands,
    recorded once per memoised key, and raises for operands on the card."""
    reg = LoweringRegistry()
    op = _shuffle_only(reg)
    pol = ExecutionPolicy(mode="auto", dialect="uisa-universal10")
    with pytest.warns(LoweringFallbackWarning):
        low = reg.select(op, pol, device=torch.device("cpu"))
    assert low.mode is IsaMode.LIBRARY and low.impl(1) == ("library", 1)
    event = reg.fallback_events[-1]
    assert (event.op, event.requested, event.used) == (op, "auto", "library")
    assert reg.select(op, pol, device=torch.device("cpu")) is low
    assert len(reg.fallback_events) == 1
    with pytest.raises(UnsupportedLowering, match="on the card"):
        reg.select(op, pol, device=torch.device("cuda", 0))
    with pytest.raises(UnsupportedLowering, match="on the card"):
        reg.select(op, pol, device="cuda")
    assert len(reg.fallback_events) == 1
    # with lane shuffle legal the kernel is picked on either device
    ada = ExecutionPolicy(mode="auto", dialect="nvidia-ada-sm89")
    assert reg.select(op, ada, device="cuda").mode is \
        IsaMode.ABSTRACT_SHUFFLE


def test_no_lowering_at_all_raises():
    reg = LoweringRegistry()
    contract = KernelContract(
        kernel="lonely", mode=IsaMode.ABSTRACT_SHUFFLE,
        primitives=frozenset({Primitive.LANE_SHUFFLE}))
    reg.register("lonely", IsaMode.ABSTRACT_SHUFFLE, lambda: None,
                 contract=contract)
    with pytest.raises(UnsupportedLowering, match="no library"):
        reg.select("lonely", ExecutionPolicy(mode="auto",
                                             dialect="uisa-universal10"))


def _copy_rows(reg, op):
    for mode in ("abstract", "abstract+shuffle", "native", "library"):
        low = REGISTRY.variant(op, mode)
        reg.register(op, mode, low.impl,
                     contract=None if mode == "library" else low.contract,
                     cost=low.cost, target=low.target)


def test_memo_returns_the_same_lowering_and_is_cleared():
    reg = LoweringRegistry()
    _copy_rows(reg, "rmsnorm_matmul")
    pol = ExecutionPolicy(mode="auto")
    shape = dict(rows=8, d=4096, n=6144)
    first = reg.select("rmsnorm_matmul", pol, shape=shape, device="cuda")
    assert reg.select("rmsnorm_matmul", pol, shape=dict(shape),
                      device="cuda") is first
    assert len(reg._auto_memo) == 1
    # another device type, shape or policy is another key
    reg.select("rmsnorm_matmul", pol, shape=shape, device="cpu")
    reg.select("rmsnorm_matmul", pol, shape=dict(shape, rows=9))
    reg.select("rmsnorm_matmul", ExecutionPolicy(
        mode="auto", dialect="amd-rdna3"), shape=shape)
    assert len(reg._auto_memo) == 4
    clears = [
        lambda: _copy_rows(reg, "rmsnorm_swiglu"),
        lambda: reg.declare_fallback("rmsnorm_swiglu", "abstract+shuffle",
                                     "abstract", reason="test"),
        lambda: (_copy_rows(reg, "rmsnorm_matmul_q8"),
                 reg._auto_memo.update({("k",): first}),
                 reg.register_precision_variant("rmsnorm_matmul", "int8",
                                                "rmsnorm_matmul_q8")),
        lambda: reg.unregister("rmsnorm_swiglu"),
    ]
    for clear in clears:
        reg.select("rmsnorm_matmul", pol, shape=shape)
        assert reg._auto_memo
        clear()
        assert not reg._auto_memo
    # the memo never changes the answer
    assert reg.select("rmsnorm_matmul", pol, shape=shape).mode is first.mode


def test_bare_policy_dispatches():
    """``ExecutionPolicy()`` is auto: a bare policy dispatches every
    wrapper, on CPU tensors through the picked mode's plain version."""
    assert ExecutionPolicy().mode == "auto"
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 64, generator=gen)
    w = torch.randn(64, generator=gen)
    wp = torch.randn(64, 48, generator=gen)
    got = ops.fused_rmsnorm_matmul(x, w, wp, policy=ExecutionPolicy())
    want = fused.rmsnorm_matmul_plain(x, w, wp, mode="native")
    torch.testing.assert_close(got, want)
    assert float(ops.reduce_sum(x, policy=ExecutionPolicy())) == \
        pytest.approx(float(x.sum()), rel=1e-5, abs=1e-5)


def test_none_fuses_under_auto():
    pol = ParallelConfig(isa_mode="auto").execution_policy()
    assert pol.mode == pol.kernel_mode == "auto" and pol.fuses()
    cfg = ModelConfig(**dataclasses.asdict(tiny_model()[1]))
    assert ParamLayout.plan(cfg, pol) == ParamLayout(attn_qkv=True,
                                                     mlp_swiglu=True)
    assert not ParallelConfig(isa_mode="auto", fuse_epilogues=False
                              ).execution_policy().fuses()


# ---------------------------------------------------------------------------
# ssd_scan(chunk=None) against the JAX package's
# ---------------------------------------------------------------------------


#: (dialect, mode) pairs both packages can run
SCAN_CASES = [("tpu-v5e", "abstract+shuffle"), ("tpu-v5e", "auto"),
              ("uisa-universal10", "abstract"),
              ("uisa-universal10", "auto"), ("nvidia-ada-sm89", "auto"),
              ("amd-rdna3", "library")]


@pytest.mark.parametrize("name,mode", SCAN_CASES)
@pytest.mark.parametrize("l", [37, 64])
def test_ssd_scan_chunk_none_equals_reference(name, mode, l):
    """At the reduced mamba config's widths (8 heads of 16, N 16): the
    chunk the port resolves is JAX's for the same dialect, and so is the
    output."""
    cfg = ref_reduced("mamba2-2.7b").ssm
    h = cfg.expand * 64 // cfg.head_dim
    x, dt, A, Bm, Cm, h0 = _scan_inputs(l, 2, l, h, cfg.head_dim, 1,
                                        cfg.state_dim, True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want_y, want_state = ref_ops.fused_ssd_scan(
            _j(x), _j(dt), _j(A), _j(Bm), _j(Cm), chunk=None,
            initial_state=_j(h0), policy=RefPolicy(mode=mode, dialect=name))
        got_y, got_state = ops.fused_ssd_scan(
            *[_t(a) for a in (x, dt, A, Bm, Cm)], chunk=None,
            initial_state=_t(h0), policy=ExecutionPolicy(mode=mode,
                                                         dialect=name))
    _close(got_y, want_y, ACCUM)
    _close(got_state, want_state, ACCUM)
    picked = REGISTRY.select("ssd_scan", ExecutionPolicy(
        mode=mode, dialect=name), shape=dict(
            b=2, seq=l, h=h, p=cfg.head_dim, g=1, n=cfg.state_dim,
            chunk=None)).mode.value
    from repro.kernels import ssd as ref_ssd
    assert ssd.resolve_chunk(l, None, mode=picked, p=cfg.head_dim,
                             n=cfg.state_dim, plan_dialect=name) == \
        ref_ssd.resolve_chunk(picked, l, cfg.head_dim, cfg.state_dim, None,
                              name)


# ---------------------------------------------------------------------------
# The engine's tokens under isa_mode="auto"
# ---------------------------------------------------------------------------


#: (JAX dialect, port dialect): each package's own target, or one shared
AUTO_DIALECTS = [(None, None), ("uisa-universal10", "uisa-universal10")]


def _auto_setup(ref_dialect, port_dialect, mode="auto"):
    cfg = tiny_model()[1]
    kw = dict(isa_mode=mode, use_pallas_attn=True)
    ref = ref_build(cfg, RefPar(remat="none", isa_dialect=ref_dialect,
                                **kw))
    ref_params = ref.init_params(jax.random.PRNGKey(0))
    port = build_model(ModelConfig(**dataclasses.asdict(cfg)),
                       ParallelConfig(isa_dialect=port_dialect, **kw),
                       device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), "cpu")
    plain = ref_build(cfg, RefPar(remat="none"))

    @jax.jit
    def all_logits(tokens):
        import jax.numpy as jnp
        x = plain._embed(ref_params, tokens, {})
        positions = jnp.arange(tokens.shape[1])[None]
        x, _, _ = plain._scan_blocks(ref_params, x, positions)
        return plain._head(ref_params, x)[0]

    return ref, ref_params, port, params, cfg, all_logits


@pytest.mark.parametrize("dialects", AUTO_DIALECTS,
                         ids=["targets", "uisa-universal10"])
def test_engine_tokens_under_auto_equal_reference(dialects):
    setup = _auto_setup(*dialects)
    assert setup[2].policy.fuses() and setup[2].param_layout.attn_qkv
    cfg = setup[4]
    ref_eng, want, eng, got = _run_both(
        setup, _prompts(cfg, 3, seed=4), [5, 6, 4], batch_slots=2,
        max_seq_len=32, eos_id=-1)
    assert _tokens(got) == _tokens(want)
    assert eng.tick_count == ref_eng.tick_count


def test_foreign_dialect_serves_on_cpu():
    """``ParallelConfig(isa_dialect=<a reference dialect>)`` resolves its
    kernel path to auto and serves the JAX engine's tokens."""
    setup = _auto_setup("nvidia-ada-sm89", "nvidia-ada-sm89", mode=None)
    assert setup[2].policy.kernel().mode == "auto"
    ref_eng, want, eng, got = _run_both(
        setup, _prompts(setup[4], 3, seed=4), [4, 5, 4], batch_slots=2,
        max_seq_len=32, eos_id=-1)
    assert _tokens(got) == _tokens(want)
