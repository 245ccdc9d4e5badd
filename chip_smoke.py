#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card's name and power limit (``nvidia-smi``);
2. the kernels, built from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, in parallel);
3. each kernel at every granite-8b shape class the main path gives it
   (decode and prefill rows, lm_head, partial tiles), in bf16, held
   against its plain PyTorch version on the same inputs (tolerance: in
   every output row max|err| <= 2e-2 x max|plain row|, and
   ||err|| <= 1e-2 x ||plain||), timed beside its plain version, one
   PyTorch library call computing the same function, and the card's least
   time for the work (bound);
4. a reference check on a small input: granite-8b-reduced in f32 served by
   the paged engine through the kernels on the card and through the plain
   versions on the CPU, same parameters; tokens must be equal and the
   prefill logits within rtol = atol = 2e-4;
5. the main path: granite-8b at full width (random weights from seed 0,
   bf16) serving 12 requests (prompts of 128-512 tokens, two sharing a
   full-page prefix, 32 new tokens each) through the paged BatchedEngine on
   8 slots; every kernel of the path must have launched;
6. a dense-cache engine pass (reduced depth) so the per-slot ``pos`` shape
   of flash_attention_matmul launches on the engine's path, and one decode
   tick under ``torch.cuda.set_sync_debug_mode("error")``;
7. the SSD kernels at the mamba2-2.7b shapes (prefill scans of 512, 300
   and 128 tokens, one with an initial state; the decode recurrence at 8
   and 5 slots), y and the f32 state each held against the plain version
   (same tolerances) and timed like the others;
8. a reference check: mamba2-2.7b-reduced in f32 served through the
   kernels on the card and through the plain versions on the CPU; tokens
   equal, prefill logits within rtol = atol = 1e-3 (the scan carries f32
   state across chunks, so the order of its sums differs);
9. the mamba main path: mamba2-2.7b at full width and depth (random
   weights from seed 0, bf16) serving 12 requests (128-512 prompt tokens,
   32 new tokens each) through the dense-state BatchedEngine on 8 slots;
   ssd_scan must have launched once per layer per prefill and ssd_decode
   once per layer per tick; then tick time, a profile, and one tick under
   ``set_sync_debug_mode("error")``;
10. the paper's Table V: gemm {abstract, native}, reduction {abstract,
    abstract+shuffle, native} and histogram {abstract, native}, each held
    against its plain version of the same mode at the paper's sizes (GEMM
    N = 4096 f32, 2^24 f32 values, 2^24 int32 values into 256 bins, and
    every value in one bin) and at ragged sizes (reduction n = 999 and
    70,001; histogram with out-of-range values into 100 bins; GEMM 300 x
    129 @ 129 x 200 and 300 x 200 @ 200 x 129), with the tolerances of
    ``repro_torch.benchmarks.tablev`` (reduction: |sum - float64 sum| <=
    1e-5 sum|x|; histogram: exact, counts summing to n; GEMM against the
    float64 product: relative RMS <= 1e-5, in every row max|err| <= 1e-4
    max|row|); then the Table V run itself (every mode through
    ``kernels.ops``, timed), after which every (kernel, mode) must have
    launched.

Prints a JSON line of per-kernel numbers (one row per kernel and shape,
or per Table V kernel, mode and case; ``launches`` is the main-path count
of the kernel the shape belongs to, ``max_abs_err`` beside the
row-relative and RMS errors and their tolerances; a kernel with two
outputs reports its worst and each output's errors; a Table V row adds its
launch parameters and its time as a percentage of native), then the card
line, then
``{"ok": true, "device": {...}}`` as the last line.  Imports nothing of JAX
or of the JAX package.
"""
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS_BF16 = 989e12           # dense tensor-core bf16
L2_FLUSH_BYTES = 128 << 20
TOL_ROW = 2e-2                     # max|err row| / max|plain row|
TOL_RMS = 1e-2                     # ||err|| / ||plain||

PAGE, MAX_LEN, SLOTS, NEW_TOKENS = 64, 576, 8, 32


def log(*args):
    print(*args, flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, flush=None) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events around
    each call; the L2 cache is flushed between calls, as a decode tick
    finds each layer's weights cold).  The flush reads a buffer larger
    than L2: a flush that wrote it would leave dirty lines, and the timed
    kernel would pay for writing them back.  A short device sleep before
    each call lets the host enqueue the call before the device reaches
    it, so a kernel shorter than its wrapper's host time is timed alone."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.amax()
        torch.cuda._sleep(200_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS_BF16 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phase 3: the kernels at main-path shapes
# --------------------------------------------------------------------------


def kernel_cases(fused, dev, cfg):
    """One dict per (kernel, main-path shape): entry name, the counter of
    the kernel it launches, kernel / plain / library fns, bytes, flops,
    source, replaces.  The shapes are granite-8b's serving shapes and take
    every path the main path takes: the decode tile with split K (qkv,
    [wi|wg]) and without (lm_head, N = 49152), the prefill tile with split
    K (300 rows) and without (512 rows, and [wi|wg] at 300 rows), and the
    causal attention with full (512) and partial (300) query and key
    tiles."""
    import torch.nn.functional as F
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    bf = torch.bfloat16
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    f, eps, vocab = cfg.d_ff, cfg.norm_eps, cfg.vocab_size
    qkv_n = (h + 2 * hkv) * hd

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf)

    w = rand(d)
    cases = []
    # rmsnorm -> [wq|wk|wv] (decode and prefill rows), final norm -> lm_head
    W_qkv = rand(d, qkv_n, scale=d ** -0.5)
    W_head = rand(d, vocab, scale=d ** -0.5)
    for name, rows, W in (("rmsnorm_matmul", SLOTS, W_qkv),
                          ("rmsnorm_matmul_lm_head", SLOTS, W_head),
                          ("rmsnorm_matmul_prefill300", 300, W_qkv),
                          ("rmsnorm_matmul_prefill512", 512, W_qkv)):
        x, n = rand(rows, d), W.shape[1]
        cases.append(dict(
            name=name, counter="rmsnorm_matmul",
            shape=f"x [{rows},{d}] @ W [{d},{n}] bf16",
            kernel=lambda x=x, W=W: fused.rmsnorm_matmul(x, w, W),
            plain=lambda x=x, W=W: fused.rmsnorm_matmul_plain(x, w, W),
            library=lambda x=x, W=W: F.rms_norm(x, (d,), w, eps) @ W,
            bytes=2 * (rows * d + d + d * n + rows * n),
            flops=2 * rows * d * n,
            source="src/repro_torch/csrc/rmsnorm_matmul.cu",
            replaces="src/repro/kernels/fused.py:296"))
    # rmsnorm -> [wi|wg] swiglu (decode and prefill rows)
    w_cat = rand(d, 2 * f, scale=d ** -0.5)
    for name, rows in (("rmsnorm_swiglu", SLOTS),
                       ("rmsnorm_swiglu_prefill300", 300)):
        x = rand(rows, d)

        def swiglu_library(x=x):
            hcat = F.rms_norm(x, (d,), w, eps) @ w_cat
            return F.silu(hcat[:, f:]) * hcat[:, :f]
        cases.append(dict(
            name=name, counter="rmsnorm_swiglu",
            shape=f"x [{rows},{d}] @ w_cat [{d},{2 * f}] bf16",
            kernel=lambda x=x: fused.rmsnorm_swiglu(x, w, w_cat),
            plain=lambda x=x: fused.rmsnorm_swiglu_plain(x, w, w_cat),
            library=swiglu_library,
            bytes=2 * (rows * d + d + d * 2 * f + rows * f),
            flops=2 * rows * d * 2 * f,
            source="src/repro_torch/csrc/rmsnorm_swiglu.cu",
            replaces="src/repro/kernels/fused.py:1212"))
    # causal prefill attention + wo (one prompt)
    wo = rand(h * hd, d, scale=(h * hd) ** -0.5)
    for name, sq in (("flash_attention_matmul", 512),
                     ("flash_attention_matmul_prefill300", 300)):
        q, k, v = rand(1, h, sq, hd), rand(1, hkv, sq, hd), rand(1, hkv, sq, hd)

        def causal_library(q=q, k=k, v=v, sq=sq):
            o = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               enable_gqa=True)
            return o.transpose(1, 2).reshape(1, sq, h * hd) @ wo
        pairs = sq * (sq + 1) // 2
        cases.append(dict(
            name=name, counter="flash_attention_matmul",
            shape=f"causal B=1, {h}/{hkv} heads x {hd}, {sq} tokens, "
                  f"wo [{h * hd},{d}] bf16",
            kernel=lambda q=q, k=k, v=v: fused.flash_attention_matmul(
                q, k, v, wo),
            plain=lambda q=q, k=k, v=v: fused.flash_attention_matmul_plain(
                q, k, v, wo),
            library=causal_library,
            bytes=2 * (q.numel() + k.numel() + v.numel() + wo.numel()
                       + sq * d),
            flops=h * pairs * 4 * hd + 2 * sq * h * hd * d,
            source="src/repro_torch/csrc/flash_attention_matmul.cu",
            replaces="src/repro/kernels/fused.py:702"))
    # dense decode attention + wo, per-slot frontiers
    rng = np.random.default_rng(0)
    pos_np = rng.integers(128, MAX_LEN - NEW_TOKENS, SLOTS).astype(np.int32)
    pos = torch.from_numpy(pos_np).to(dev)
    qd = rand(SLOTS, h, 1, hd)
    kd, vd = rand(SLOTS, hkv, MAX_LEN, hd), rand(SLOTS, hkv, MAX_LEN, hd)
    mask = (torch.arange(MAX_LEN, device=dev)[None] <= pos[:, None]
            )[:, None, None, :]

    def pos_library():
        o = F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask,
                                           enable_gqa=True)
        return o.transpose(1, 2).reshape(SLOTS, 1, h * hd) @ wo
    visible = int((pos_np + 1).sum())
    dec_flops = h * visible * 4 * hd + 2 * SLOTS * h * hd * d
    dec_bytes = 2 * (qd.numel() + 2 * hkv * hd * visible + wo.numel()
                     + SLOTS * d) + 4 * SLOTS
    cases.append(dict(
        name="flash_attention_matmul_pos",
        counter="flash_attention_matmul_pos",
        shape=f"{SLOTS} slots x {MAX_LEN}-key cache, frontiers "
              f"{int(pos_np.min())}-{int(pos_np.max())} bf16",
        kernel=lambda: fused.flash_attention_matmul(qd, kd, vd, wo, pos=pos),
        plain=lambda: fused.flash_attention_matmul_plain(qd, kd, vd, wo,
                                                         pos=pos),
        library=pos_library, bytes=dec_bytes, flops=dec_flops,
        source="src/repro_torch/csrc/flash_attention_matmul.cu",
        replaces="src/repro/kernels/fused.py:702"))
    # paged decode attention + wo
    maxp = MAX_LEN // PAGE
    num_pages = SLOTS * maxp
    kp = rand(num_pages, hkv, PAGE, hd)
    vp = rand(num_pages, hkv, PAGE, hd)
    tables = torch.from_numpy(rng.permutation(num_pages).astype(np.int32)
                              .reshape(SLOTS, maxp)).to(dev)
    cases.append(dict(
        name="paged_attention_matmul", counter="paged_attention_matmul",
        shape=f"{SLOTS} slots, {num_pages} pages of {PAGE}, same frontiers "
              f"bf16",
        kernel=lambda: fused.paged_attention_matmul(
            qd, kp, vp, wo, block_tables=tables, pos=pos),
        plain=lambda: fused.paged_attention_matmul_plain(
            qd, kp, vp, wo, block_tables=tables, pos=pos),
        library=None, bytes=dec_bytes + 4 * SLOTS * maxp, flops=dec_flops,
        source="src/repro_torch/csrc/paged_attention_matmul.cu",
        replaces="src/repro/kernels/fused.py:854"))
    return cases


def ssd_kernel_cases(ssd, dev, cfg):
    """The SSD kernels at mamba2-2.7b's serving shapes: the prefill scan
    over one prompt of 512 tokens (two full chunks of 256), 300 tokens (a
    partial last chunk), 128 tokens (one chunk, clamped to the prompt) and
    300 tokens seeded from a nonzero initial state; the decode recurrence
    at 8 slots and at an odd 5.  Inputs have the model's magnitudes: dt =
    softplus(. + dt_bias) with the model's dt_bias, A = -linspace(1, 16),
    B and C scaled so that C.B is O(1).  Each kernel has two outputs, y
    and the f32 state, both compared.  No single PyTorch call computes
    either function, so library_ms is null."""
    s = cfg.ssm
    h = s.expand * cfg.d_model // s.head_dim
    p, n, g, q = s.head_dim, s.state_dim, s.n_groups, s.chunk_size
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    bf = torch.bfloat16
    A = -torch.linspace(1.0, 16.0, h, device=dev)
    dt_bias = torch.log(torch.expm1(torch.linspace(s.dt_min, s.dt_max, h,
                                                   device=dev)))

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def dts(*lead):
        return torch.nn.functional.softplus(rand(*lead, h) + dt_bias)

    itemsize = 2
    no_library = "no single PyTorch call computes this function"
    cases = []
    for name, l, init in (("ssd_scan", 512, False),
                          ("ssd_scan_prefill300", 300, False),
                          ("ssd_scan_prefill128", 128, False),
                          ("ssd_scan_h0", 300, True)):
        x = rand(1, l, h, p).to(bf)
        dt = dts(1, l)
        B = rand(1, l, g, n, scale=n ** -0.25).to(bf)
        C = rand(1, l, g, n, scale=n ** -0.25).to(bf)
        h0 = rand(1, g, h // g, n, p, scale=0.5) if init else None
        qq = min(q, l)
        flops = 0
        for c0 in range(0, l, qq):
            m = min(qq, l - c0)
            pairs = m * (m + 1) // 2
            # C.B^T once per group, decay-weighted w.x and the state update
            # per head, and the carried state's C.h where it is not zero
            flops += 2 * g * pairs * n + 2 * h * pairs * p \
                + 2 * h * m * n * p * (2 if (c0 > 0 or init) else 1)
        nbytes = (itemsize * (2 * l * h * p + 2 * l * g * n)
                  + 4 * (l * h + h + h * n * p * (2 if init else 1)))
        cases.append(dict(
            name=name, counter="ssd_scan", outputs=("y", "state"),
            shape=f"B=1, L={l}, {h} heads x {p}, N={n}, G={g}, chunk {qq}"
                  f"{', initial state' if init else ''}, bf16 (state f32)",
            kernel=lambda x=x, dt=dt, B=B, C=C, h0=h0: ssd.ssd_scan(
                x, dt, A, B, C, h0, chunk=q),
            plain=lambda x=x, dt=dt, B=B, C=C, h0=h0: ssd.ssd_scan_plain(
                x, dt, A, B, C, h0, chunk=q),
            library=None, library_note=no_library, bytes=nbytes,
            flops=flops, source="src/repro_torch/csrc/ssd_scan.cu",
            replaces="src/repro/kernels/ssd.py:289"))
    for name, b in (("ssd_decode", SLOTS), ("ssd_decode_b5", 5)):
        state = rand(b, g, h // g, n, p, scale=0.5)
        x = rand(b, h, p).to(bf)
        dt = dts(b)
        B = rand(b, g, n, scale=n ** -0.25).to(bf)
        C = rand(b, g, n, scale=n ** -0.25).to(bf)
        cases.append(dict(
            name=name, counter="ssd_decode", outputs=("state", "y"),
            shape=f"{b} slots x {h} heads, state [{n},{p}] f32, bf16",
            kernel=lambda state=state, x=x, dt=dt, B=B, C=C: ssd.ssd_decode(
                state, x, dt, A, B, C),
            plain=lambda state=state, x=x, dt=dt, B=B, C=C:
                ssd.ssd_decode_plain(state, x, dt, A, B, C),
            library=None, library_note=no_library,
            bytes=4 * 2 * b * h * n * p + itemsize * (2 * b * h * p
                                                      + 2 * b * g * n)
            + 4 * (b * h + h),
            flops=5 * b * h * n * p,
            source="src/repro_torch/csrc/ssd_decode.cu",
            replaces="src/repro/kernels/ssd.py:437"))
    return cases


def compare(out, ref):
    """(max abs error, max over output rows of max|err row| / max|plain
    row|, ||err|| / ||plain||): the row-scaled bound keeps a row of small
    values (late causal queries) from hiding under a large row's tolerance,
    the relative RMS bounds the error of the tensor as a whole."""
    o = out.float().reshape(-1, out.shape[-1])
    r = ref.float().reshape(-1, ref.shape[-1])
    diff = (o - r).abs()
    row = diff.amax(dim=1) / r.abs().amax(dim=1).clamp_min(1e-30)
    return (float(diff.max()), float(row.max()),
            float(torch.linalg.vector_norm(o - r)
                  / torch.linalg.vector_norm(r).clamp_min(1e-30)))


def run_kernels(cases, dev):
    flush = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    rows = []
    for case in cases:
        outs = case["kernel"]()
        refs = case["plain"]()
        torch.cuda.synchronize()
        names = case.get("outputs", ("out",))
        if len(names) == 1:
            outs, refs = (outs,), (refs,)
        parts = {}
        for part, out, ref in zip(names, outs, refs):
            check(out.shape == ref.shape, f"{case['name']} {part}: shape "
                  f"{tuple(out.shape)} != {tuple(ref.shape)}")
            check(torch.isfinite(out.float()).all().item(),
                  f"{case['name']} {part}: non-finite output")
            parts[part] = compare(out, ref)
        del outs, refs
        err, row_err, rms_err = (max(v[i] for v in parts.values())
                                 for i in range(3))
        ms = time_ms(case["kernel"], flush=flush)
        plain_ms = time_ms(case["plain"], flush=flush)
        lib_ms = (time_ms(case["library"], flush=flush)
                  if case["library"] is not None else None)
        bms, by = bound_ms(case["bytes"], case["flops"])
        each = "".join(f"; {part}: max_abs_err {v[0]:.4g}, row-relative "
                       f"{v[1]:.4g}, relative RMS {v[2]:.4g}"
                       for part, v in parts.items()) if len(parts) > 1 else ""
        log(f"kernel {case['name']} ({case['shape']}): max_abs_err {err:.4g}"
            f", row-relative {row_err:.4g} (tol {TOL_ROW}), relative RMS "
            f"{rms_err:.4g} (tol {TOL_RMS}){each}; ms {ms:.4f} plain_ms "
            f"{plain_ms:.4f} library_ms "
            f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} bound_ms "
            f"{bms:.4f} ({by})")
        check(row_err <= TOL_ROW, f"{case['name']}: row-relative error "
              f"{row_err} > {TOL_ROW}")
        check(rms_err <= TOL_RMS, f"{case['name']}: relative RMS error "
              f"{rms_err} > {TOL_RMS}")
        row = dict(name=case["name"], route="cuda", source=case["source"],
                   replaces=case["replaces"], launches=0, max_abs_err=err,
                   ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                   library_ms=lib_ms, counter=case["counter"],
                   shape=case["shape"], row_rel_err=row_err,
                   tol_row_rel=TOL_ROW, rel_rms_err=rms_err,
                   tol_rel_rms=TOL_RMS)
        if len(parts) > 1:
            row["outputs"] = {part: dict(max_abs_err=v[0], row_rel_err=v[1],
                                         rel_rms_err=v[2])
                              for part, v in parts.items()}
        if "library_note" in case:
            row["library_note"] = case["library_note"]
        rows.append(row)
    del flush
    torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------------------
# phases 4-6: the engine
# --------------------------------------------------------------------------


def main_path_policy(ParallelConfig):
    return ParallelConfig(fuse_epilogues=True, use_pallas_attn=True)


def reference_check(build_model, ParallelConfig, get_reduced, Engine,
                    Request, ServeConfig, dev):
    """granite-8b-reduced (f32): kernels on the card vs plain on the CPU."""
    cfg = get_reduced("granite-8b")
    par = main_path_policy(ParallelConfig)
    cpu_model = build_model(cfg, par, device="cpu")
    params_cpu = cpu_model.init_params(0)
    gpu_model = build_model(cfg, par, device=dev)
    params_gpu = _to_device(params_cpu, dev)
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(2, cfg.vocab_size, n)]
               for n in (9, 17, 5, 12)]
    prompts[1][:8] = prompts[0][:8]                    # one shared page
    toks = torch.tensor([prompts[0]], dtype=torch.int32)
    want, _ = cpu_model.prefill(params_cpu, {"tokens": toks})
    got, _ = gpu_model.prefill(params_gpu, {"tokens": toks.to(dev)})
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                               rtol=2e-4, atol=2e-4)
    runs = []
    for model, params in ((cpu_model, params_cpu), (gpu_model, params_gpu)):
        eng = Engine(model, params, ServeConfig(
            batch_slots=2, max_seq_len=32, eos_id=-1, page_size=8))
        done = eng.run([Request(rid=i, prompt=list(p), max_new_tokens=8)
                        for i, p in enumerate(prompts)])
        runs.append({r.rid: r.generated for r in done})
    check(runs[0] == runs[1], f"reduced engine tokens differ: {runs}")
    log(f"reference check: granite-8b-reduced f32, {len(prompts)} requests, "
        f"card tokens == CPU tokens, prefill logits within 2e-4")


def _to_device(tree, dev):
    return {k: _to_device(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def profile_ticks(eng, ticks: int):
    """Device busy ms per tick over ``ticks`` decode ticks (torch.profiler),
    by kernel; None when the profiler recorded no device time.  The
    profiler slows the host, so the wall time it prints is not the tick's."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # kernels only: an operator (aten::mm) repeats its kernels' time
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        self_us = getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0))
        if self_us > 0:
            rows.append((self_us / 1e3 / ticks, e.count // ticks, e.key))
    busy = sum(r[0] for r in rows)
    if not rows:
        log("profile: the profiler recorded no device time")
        return None
    log(f"profile ({ticks} ticks): device busy {busy:.3f} ms/tick "
        f"(wall {wall_ms / ticks:.3f} ms/tick with the profiler on)")
    for ms, count, key in sorted(rows, reverse=True)[:12]:
        log(f"profile: {ms:8.3f} ms/tick {count:5d} launches/tick  {key[:90]}")
    return busy


def measure_tick(eng, Request, prompts, label: str) -> float:
    """The steady decode tick at 8 live slots, after a run: admit 8 fresh
    requests (128-token prompts), warm up one tick, time 16 on the host
    clock, then profile 3 and print the device's idle share."""
    more = [Request(rid=100 + i, prompt=prompts[i][:128], max_new_tokens=64)
            for i in range(SLOTS)]
    check(eng.admit(more) == SLOTS, f"{label}: tick probe admission failed")
    eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(16):
        eng.step()
    torch.cuda.synchronize()
    tick_ms = (time.perf_counter() - t0) / 16 * 1e3
    log(f"{label} decode tick: {tick_ms:.3f} ms at {SLOTS} live slots "
        f"(host clock, 16 ticks)")
    busy = profile_ticks(eng, ticks=3)
    if busy is not None:
        log(f"{label} idle share: {max(0.0, 1 - busy / tick_ms):.3f} "
            f"(1 - profiled device busy / unprofiled tick)")
    torch.cuda.synchronize()
    return tick_ms


def serve_main_path(fused, build_model, ParallelConfig, cfg, Engine, Request,
                    ServeConfig, dev):
    t0 = time.perf_counter()
    model = build_model(cfg, main_path_policy(ParallelConfig), device=dev)
    params = model.init_params(0)
    torch.cuda.synchronize()
    log(f"main path: {cfg.name} at full width, {cfg.num_layers} layers, "
        f"bf16, random weights from seed 0, init "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(2)
    lens = rng.integers(128, 513, 12)
    prompts = [[int(t) for t in rng.integers(2, cfg.vocab_size, n)]
               for n in lens]
    prompts[1][:2 * PAGE] = prompts[0][:2 * PAGE]      # two shared pages
    eng = Engine(model, params, ServeConfig(
        batch_slots=SLOTS, max_seq_len=MAX_LEN, eos_id=-1, page_size=PAGE,
        max_new_tokens=NEW_TOKENS))
    reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]
    fused.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(fused.LAUNCHES)
    check(len(done) == 12 and all(r.done and not r.rejected for r in done),
          "not every request finished")
    check(all(len(r.generated) == NEW_TOKENS and
              all(0 <= t < cfg.vocab_size for t in r.generated)
              for r in done), "wrong generated tokens")
    check(eng.pool.shared_hits >= 2, "the shared prefix was not shared")
    n_gen = sum(len(r.generated) for r in done)
    stats = eng.tick_stats
    log(f"main path: 12 requests, prompts {int(lens.min())}-{int(lens.max())}"
        f" tokens ({int(lens.sum())} total), {n_gen} tokens generated in "
        f"{wall:.3f} s = {n_gen / wall:.1f} tokens/s (prefill included), "
        f"{eng.tick_count} ticks")
    log(f"main path tick_stats: ticks {len(stats)}, max live_slots "
        f"{max(s['live_slots'] for s in stats)}, max frontier_pages "
        f"{max(s['frontier_pages'] for s in stats)}, max pool_utilization "
        f"{max(s['pool_utilization'] for s in stats):.3f}, "
        f"shared_prefix_hits {eng.pool.shared_hits}")
    log(f"main path launches: {json.dumps(counts)}")
    for name in ("rmsnorm_matmul", "rmsnorm_swiglu", "flash_attention_matmul",
                 "paged_attention_matmul"):
        check(counts[name] > 0, f"{name} never launched on the main path")
    tick_ms = measure_tick(eng, Request, prompts, "main path")
    logits, _ = model.prefill(params, {"tokens": torch.tensor(
        [prompts[0]], dtype=torch.int32, device=dev)})
    check(logits.shape == (1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "non-finite logits")
    del eng, params, model
    torch.cuda.empty_cache()
    return counts, n_gen / wall, tick_ms


def serve_dense_pass(fused, build_model, ParallelConfig, cfg, Engine,
                     Request, ServeConfig, dev, layers: int = 4):
    cfg = dataclasses.replace(cfg, num_layers=layers)
    model = build_model(cfg, main_path_policy(ParallelConfig), device=dev)
    params = model.init_params(1)
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, prompt=[int(t) for t in rng.integers(
        2, cfg.vocab_size, int(n))], max_new_tokens=8)
        for i, n in enumerate(rng.integers(128, 257, SLOTS))]
    eng = Engine(model, params, ServeConfig(
        batch_slots=SLOTS, max_seq_len=MAX_LEN, eos_id=-1))
    fused.reset_launch_counts()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    counts = dict(fused.LAUNCHES)
    check(all(r.done and len(r.generated) == 8 for r in done),
          "dense pass: not every request finished")
    log(f"dense pass: {layers} layers at full width, {len(done)} requests, "
        f"launches {json.dumps(counts)}")
    for name in ("rmsnorm_matmul", "rmsnorm_swiglu", "flash_attention_matmul",
                 "flash_attention_matmul_pos"):
        check(counts[name] > 0, f"{name} never launched on the dense pass")
    # one tick with host syncs forbidden (after a warm-up tick)
    check(eng.admit([Request(rid=99, prompt=[5, 6, 7], max_new_tokens=16)])
          == 1, "sync probe admission failed")
    eng.step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("dense pass: one decode tick under set_sync_debug_mode('error'): "
        "no host sync")
    return counts


# --------------------------------------------------------------------------
# phases 8-9: the mamba path
# --------------------------------------------------------------------------


def mamba_reference_check(build_model, ParallelConfig, get_reduced, Engine,
                          Request, ServeConfig, dev):
    """mamba2-2.7b-reduced (f32): the SSD kernels on the card vs the plain
    versions on the CPU, same parameters."""
    cfg = get_reduced("mamba2-2.7b")
    par = ParallelConfig(fuse_epilogues=True)
    cpu_model = build_model(cfg, par, device="cpu")
    params_cpu = cpu_model.init_params(0)
    gpu_model = build_model(cfg, par, device=dev)
    params_gpu = _to_device(params_cpu, dev)
    rng = np.random.default_rng(4)
    prompts = [[int(t) for t in rng.integers(2, cfg.vocab_size, n)]
               for n in (9, 40, 5, 23)]
    toks = torch.tensor([prompts[1]], dtype=torch.int32)
    want, _ = cpu_model.prefill(params_cpu, {"tokens": toks})
    got, _ = gpu_model.prefill(params_gpu, {"tokens": toks.to(dev)})
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                               rtol=1e-3, atol=1e-3)
    runs = []
    for model, params in ((cpu_model, params_cpu), (gpu_model, params_gpu)):
        eng = Engine(model, params, ServeConfig(
            batch_slots=2, max_seq_len=64, eos_id=-1))
        done = eng.run([Request(rid=i, prompt=list(p), max_new_tokens=8)
                        for i, p in enumerate(prompts)])
        runs.append({r.rid: r.generated for r in done})
    check(runs[0] == runs[1], f"reduced mamba engine tokens differ: {runs}")
    log(f"mamba reference check: mamba2-2.7b-reduced f32, {len(prompts)} "
        f"requests, card tokens == CPU tokens, prefill logits within 1e-3")


def serve_mamba_path(fused, build_model, ParallelConfig, cfg, Engine,
                     Request, ServeConfig, dev):
    """mamba2-2.7b at full width and depth through the dense-state engine:
    12 requests, then the tick at 8 live slots, a profile, and one tick
    with host syncs forbidden."""
    t0 = time.perf_counter()
    model = build_model(cfg, ParallelConfig(fuse_epilogues=True), device=dev)
    params = model.init_params(0)
    torch.cuda.synchronize()
    log(f"mamba path: {cfg.name} at full width, {cfg.num_layers} layers, "
        f"bf16, random weights from seed 0, init "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(5)
    lens = rng.integers(128, 513, 12)
    prompts = [[int(t) for t in rng.integers(2, cfg.vocab_size, n)]
               for n in lens]
    eng = Engine(model, params, ServeConfig(
        batch_slots=SLOTS, max_seq_len=MAX_LEN, eos_id=-1,
        max_new_tokens=NEW_TOKENS))
    reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]
    fused.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(fused.LAUNCHES)
    check(len(done) == 12 and all(r.done and not r.rejected for r in done),
          "mamba path: not every request finished")
    check(all(len(r.generated) == NEW_TOKENS and
              all(0 <= t < cfg.vocab_size for t in r.generated)
              for r in done), "mamba path: wrong generated tokens")
    n_gen = sum(len(r.generated) for r in done)
    log(f"mamba path: 12 requests, prompts {int(lens.min())}-"
        f"{int(lens.max())} tokens ({int(lens.sum())} total), {n_gen} tokens "
        f"generated in {wall:.3f} s = {n_gen / wall:.1f} tokens/s (prefill "
        f"included), {eng.tick_count} ticks")
    log(f"mamba path launches: {json.dumps(counts)}")
    want = {"ssd_scan": cfg.num_layers * len(done),
            "ssd_decode": cfg.num_layers * eng.tick_count}
    for name, n in want.items():
        check(counts[name] > 0, f"{name} never launched on the mamba path")
        check(counts[name] == n, f"{name}: {counts[name]} launches, "
              f"expected {n} (one per layer per "
              f"{'prefill' if name == 'ssd_scan' else 'tick'})")
    log(f"mamba path launch counts as expected: ssd_scan = {cfg.num_layers}"
        f" x {len(done)} prefills, ssd_decode = {cfg.num_layers} x "
        f"{eng.tick_count} ticks")
    measure_tick(eng, Request, prompts, "mamba path")
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("mamba path: one decode tick under set_sync_debug_mode('error'): "
        "no host sync")
    logits, cache = model.prefill(params, {"tokens": torch.tensor(
        [prompts[0]], dtype=torch.int32, device=dev)})
    check(logits.shape == (1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all())
          and bool(torch.isfinite(cache["h"]).all()),
          "mamba path: non-finite logits or state")
    del eng, params, model, cache
    torch.cuda.empty_cache()
    return counts


# --------------------------------------------------------------------------
# phase 10: Table V
# --------------------------------------------------------------------------

TABLEV_SOURCES = {
    "gemm": ("src/repro_torch/csrc/gemm.cu", "src/repro/kernels/gemm.py:130"),
    "reduction": ("src/repro_torch/csrc/reduction.cu",
                  "src/repro/kernels/reduction.py:95"),
    "histogram": ("src/repro_torch/csrc/histogram.cu",
                  "src/repro/kernels/histogram.py:120"),
}


def tablev_plain_checks(tablev, dev):
    """Every Table V (kernel, mode) against its plain version of the same
    mode, on the same inputs: each of the benchmark's cases at the paper's
    sizes (both held to the stated tolerance, and the plain version timed),
    then ragged sizes.  Returns, per (kernel, mode, case), the max
    |kernel - plain| and the plain version's time."""
    from repro_torch.benchmarks.common import l2_flush_buffer
    from repro_torch.kernels import gemm, histogram, reduction
    inp = tablev.make_inputs(dev, seed=0)
    ref64 = inp["a"].double() @ inp["b"].double()
    flush = l2_flush_buffer(dev)
    out = {}
    for case in tablev.cases(inp):
        got, want = case["fn"](), case["plain"]()
        tablev.check_output(case, got, inp, ref64)
        tablev.check_output(case, want, inp, ref64, " (plain)")
        if case["kernel"] == "histogram":
            check(torch.equal(got, want), f"histogram [{case['mode']}] "
                  f"{case['case']}: kernel and plain differ")
        out[(case["kernel"], case["mode"], case["case"])] = dict(
            max_abs_err=float((got.double() - want.double()).abs().max()),
            plain_ms=tablev.time_ms(case["plain"], flush=flush))
        del got, want
    del inp, ref64, flush
    # ragged sizes
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    for n in (999, 70001):
        x = torch.randn(n, generator=g, device=dev)
        for xt in (x, x.bfloat16(), (x * 8).to(torch.int32)):
            lim = tablev.REDUCTION_TOL * float(xt.double().abs().sum())
            for mode in reduction.MODES:
                what = f"reduction [{mode}] n={n} {xt.dtype}"
                got = reduction.reduce_sum(xt, mode=mode)
                tablev.check_reduction(got, xt, what)
                check(abs(float(got) - float(reduction.reduce_sum_plain(
                    xt, mode=mode))) <= lim, f"{what}: kernel and plain "
                    f"differ")
    wide = torch.randint(-50, 150, (70001,), generator=g, device=dev,
                         dtype=torch.int32)
    for mode in histogram.KERNEL_MODES:
        for bins in (100, 256):
            what = f"histogram [{mode}] n=70001, {bins} bins, out of range"
            got = histogram.histogram(wide, bins, mode=mode)
            tablev.check_histogram(got, wide, bins, what)
            check(torch.equal(got, histogram.histogram_plain(
                wide, bins, mode=mode)), f"{what}: kernel and plain differ")
    for m, k, n in ((300, 129, 200), (300, 200, 129)):
        a = torch.randn(m, k, generator=g, device=dev)
        b = torch.randn(k, n, generator=g, device=dev)
        r64 = a.double() @ b.double()
        for mode in gemm.MODES:
            what = f"gemm [{mode}] {m}x{k} @ {k}x{n}"
            tablev.check_gemm(gemm.gemm(a, b, mode=mode), r64, what)
            tablev.check_gemm(gemm.gemm_plain(a, b, mode=mode), r64,
                              what + " plain")
    torch.cuda.empty_cache()
    log("table V checks: every (kernel, mode) and its plain version within "
        "tolerance at the paper's and at ragged sizes")
    return out


def tablev_path(tablev, fused, plain, dev):
    """The Table V run with the counts set to 0 just before it and read
    just after; every (kernel, mode) must have launched.  Returns the
    kernels-line rows."""
    fused.reset_launch_counts()
    torch.cuda.synchronize()
    rows = tablev.run(dev, log=log)
    torch.cuda.synchronize()
    counts = dict(fused.LAUNCHES)
    log(f"table V launches: {json.dumps({k: v for k, v in counts.items() if v})}")
    out = []
    for r in rows:
        counter = r["counter"]
        check(counts[counter] > 0, f"{counter} never launched in the table "
              f"V run")
        name = counter + ("_tile512" if "2 per thread" in r["case"]
                          else "_one_bin" if "one bin" in r["case"]
                          else "_off16" if "off 16 B" in r["case"] else "")
        source, replaces = TABLEV_SOURCES[r["kernel"]]
        p = plain[(r["kernel"], r["mode"], r["case"])]
        out.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=counts[counter], max_abs_err=p["max_abs_err"],
            ms=r["ms"], plain_ms=p["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=r["case"], mode=r["mode"],
            pct_of_native=r["pct_of_native"], launch=r["launch"],
            max_abs_err_vs_exact=r["max_abs_err"]))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {src}",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(src))
    from repro_torch.benchmarks import tablev
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.kernels import _build, fused, ssd
    from repro_torch.models import build_model
    from repro_torch.models.config import ParallelConfig
    from repro_torch.serve import BatchedEngine, Request, ServeConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    t0 = time.perf_counter()
    build_s = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s ({build_s:.1f} s in nvcc) "
        f"into {_build.build_dir()}")
    for name in _build.SOURCES:
        regs = [line.split("Used")[1].strip() for line in
                _build.build_log(name).splitlines() if "Used" in line]
        log(f"ptxas {name}: {'; '.join(regs)}")

    cfg = get_config("granite-8b")
    mcfg = get_config("mamba2-2.7b")
    rows = run_kernels(kernel_cases(fused, dev, cfg)
                       + ssd_kernel_cases(ssd, dev, mcfg), dev)
    reference_check(build_model, ParallelConfig, get_reduced, BatchedEngine,
                    Request, ServeConfig, dev)
    paged_counts, _, _ = serve_main_path(fused, build_model, ParallelConfig,
                                         cfg, BatchedEngine, Request,
                                         ServeConfig, dev)
    dense_counts = serve_dense_pass(fused, build_model, ParallelConfig, cfg,
                                    BatchedEngine, Request, ServeConfig, dev)
    mamba_reference_check(build_model, ParallelConfig, get_reduced,
                          BatchedEngine, Request, ServeConfig, dev)
    mamba_counts = serve_mamba_path(fused, build_model, ParallelConfig, mcfg,
                                    BatchedEngine, Request, ServeConfig, dev)
    torch.set_float32_matmul_precision("highest")
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "the library GEMM must run in full f32")
    plain = tablev_plain_checks(tablev, dev)
    tablev_rows = tablev_path(tablev, fused, plain, dev)
    for row in rows:
        counter = row.pop("counter")
        counts = (dense_counts if counter == "flash_attention_matmul_pos"
                  else mamba_counts if counter.startswith("ssd_")
                  else paged_counts)
        row["launches"] = counts[counter]
    log(json.dumps({"kernels": rows + tablev_rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except (SmokeFailure, AssertionError, RuntimeError,
            subprocess.SubprocessError) as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
