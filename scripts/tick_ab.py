#!/usr/bin/env python3
"""The steady decode tick of four served models, for one checkout.

    python scripts/tick_ab.py ROOT [--label LABEL] [--readings 5]
        [--archs granite-8b mistral-nemo-12b zamba2-1.2b mamba2-2.7b]
        [--views-ab] [--auto] [--host-profile [FN ...]] [--reduced]
        [--device cuda]

ROOT is a checkout of this repository: the working tree, or a parent
commit unpacked with ``git archive``.  The script imports ROOT's
``src/repro_torch`` (the kernels built from ROOT's sources into ROOT's
``build/``) and serves each model at full width and depth, bf16, random
weights from seed 0, under the policy ``chip_smoke.py`` serves it with:
granite-8b (36 layers) and mistral-nemo-12b (40) under the fused policy
paged at 64, zamba2-1.2b (38) under the fused policy in native mode and
mamba2-2.7b (64) under ``fuse_epilogues``, both on the dense-state
engine.  Eight requests of 128 random tokens fill the eight slots; after
two warm-up ticks, each reading is 16 ticks on the host clock
(synchronized before and after), and the median of the readings is the
tick.  Prints one JSON line a model: the label, the card, the model, the
readings and their median in ms.  The ticks are host-bound, so they
measure the host's path through the model.  Needs one CUDA card.  To
compare two checkouts, run it in turns on one card (parent, change,
change, parent).  ``--views-ab`` pairs the readings in one process
instead: they alternate (A B B A ...) between the checkout's layer views
(``common.layer_views``: one ``torch.unbind`` a stacked leaf) and one
select a layer and leaf (``select_views``, the former host path), each arm
taking ``--readings``; each line then holds both arms, and each arm's
host time to build the views of the model's stacked trees once, as a
tick does (the median of 5 readings of 200 builds, in us).  ``--auto``
serves every model under ``isa_mode="auto"`` instead (with
``use_pallas_attn`` where its policy has it) and paged models at pages
of 128 (auto may pick a mode whose row reduces need them), as
``chip_smoke.py``'s phases 35 and 48 serve granite-8b.  ``--reduced
--device cpu`` runs the reduced configs on the CPU, a check of the script
and not a measurement.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SLOTS, PROMPT, MAX_LEN, TICKS, WARM = 8, 128, 576, 16, 2
AUTO_PAGE = 128
FUSED = dict(fuse_epilogues=True, use_pallas_attn=True)
#: model -> (policy, page size or None for the dense-state engine)
SERVED = {
    "granite-8b": (FUSED, 64),
    "mistral-nemo-12b": (FUSED, 64),
    "zamba2-1.2b": (dict(FUSED, isa_mode="native"), None),
    "mamba2-2.7b": (dict(fuse_epilogues=True), None),
}


def select_views(blocks):
    """Every layer of a stacked block tree by one select a layer and leaf
    (the former ``common.layer_view``, called once a layer)."""
    def view(tree, i):
        return {k: view(v, i) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}
    leaf = blocks
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return [view(blocks, i) for i in range(leaf.shape[0])]


def views_us(fn, stacks, builds: int = 200, readings: int = 5) -> float:
    """Host us to build every stack's layer views once by ``fn``: the
    median of ``readings`` readings of ``builds`` builds."""
    times = []
    for _ in range(readings):
        t0 = time.perf_counter()
        for _ in range(builds):
            for tree in stacks:
                fn(tree)
        times.append((time.perf_counter() - t0) / builds * 1e6)
    return statistics.median(times)


def host_profile(eng, sync, names, top: int = 15) -> dict:
    """16 ticks under ``cProfile``: the host ms a tick, the ``top``
    functions by own time and each function of ``names`` (by its name),
    as [calls, own ms] a tick."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    sync()
    prof.enable()
    for _ in range(TICKS):
        eng.step()
    sync()
    prof.disable()
    stats = pstats.Stats(prof).stats
    per_tick = {f"{Path(f).name}:{line}:{fn}": (nc / TICKS, tt / TICKS * 1e3)
                for (f, line, fn), (_, nc, tt, _, _) in stats.items()}
    ranked = sorted(per_tick.items(), key=lambda kv: -kv[1][1])
    named = {n: [0.0, 0.0] for n in names}
    for key, (calls, own) in per_tick.items():
        fn = key.rsplit(":", 1)[1]
        if fn in named:
            named[fn][0] += calls
            named[fn][1] += own
    return {"host_profile_ms": sum(own for _, own in per_tick.values()),
            "host_top": [[k, c, o] for k, (c, o) in ranked[:top]],
            "host_fns": named}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", type=Path)
    ap.add_argument("--label", default=None)
    ap.add_argument("--readings", type=int, default=5)
    ap.add_argument("--archs", nargs="+", default=list(SERVED),
                    choices=list(SERVED))
    ap.add_argument("--views-ab", action="store_true")
    ap.add_argument("--auto", action="store_true")
    ap.add_argument("--host-profile", nargs="*", default=None)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("tick_ab: no CUDA card is available", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.kernels import _build
    from repro_torch.models import build_model, common
    from repro_torch.models.config import ParallelConfig
    from repro_torch.serve import BatchedEngine, Request, ServeConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    sync = torch.cuda.synchronize if dev.type == "cuda" else lambda: None
    if dev.type == "cuda":
        _build.build()
    card = card_line() if dev.type == "cuda" else "cpu"
    rng = np.random.default_rng(2)
    for arch in args.archs:
        policy, page = SERVED[arch]
        if args.auto:
            policy = dict(isa_mode="auto", **{
                k: v for k, v in policy.items() if k == "use_pallas_attn"})
            page = page and AUTO_PAGE
        cfg = (get_reduced if args.reduced else get_config)(arch)
        model = build_model(cfg, ParallelConfig(**policy), device=dev)
        params = model.init_params(0)
        arms = (("unbind", "select", "select", "unbind") if args.views_ab
                else (None,))
        n_readings = args.readings * (2 if args.views_ab else 1)
        new = WARM + TICKS * n_readings + 1
        eng = BatchedEngine(model, params, ServeConfig(
            batch_slots=SLOTS, max_seq_len=MAX_LEN, eos_id=-1,
            page_size=page, max_new_tokens=new))
        reqs = [Request(rid=i, prompt=[int(t) for t in rng.integers(
            2, cfg.vocab_size, PROMPT)], max_new_tokens=new)
            for i in range(SLOTS)]
        if eng.admit(reqs) != SLOTS:
            print(f"tick_ab: {arch}: admission failed", file=sys.stderr)
            return 1
        for _ in range(WARM):
            eng.step()
        readings = {}
        unbind = common.layer_views
        for r in range(n_readings):
            arm = arms[r % len(arms)]
            common.layer_views = select_views if arm == "select" else unbind
            sync()
            t0 = time.perf_counter()
            for _ in range(TICKS):
                eng.step()
            sync()
            readings.setdefault(arm, []).append(
                (time.perf_counter() - t0) / TICKS * 1e3)
        common.layer_views = unbind
        profile = ({} if args.host_profile is None
                   else host_profile(eng, sync, args.host_profile))
        line = {"label": args.label, "card": card, "model": arch,
                "layers": cfg.num_layers, "page_size": page,
                "isa_mode": policy.get("isa_mode", "native")}
        if args.views_ab:
            stacks = [params[k] for k in ("blocks", "norms") if k in params]
            line.update({f"views_us_{arm}": views_us(fn, stacks)
                         for arm, fn in (("unbind", unbind),
                                         ("select", select_views))})
        for arm, ms in readings.items():
            tag = "" if arm is None else f"_{arm}"
            line.update({f"tick_ms{tag}": ms,
                         f"median_ms{tag}": statistics.median(ms)})
        line.update(profile)
        print(json.dumps(line), flush=True)
        del eng, params, model
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
