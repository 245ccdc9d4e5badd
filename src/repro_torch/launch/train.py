"""Training launcher, the JAX package's ``launch/train.py`` on one device:

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-8b --reduced --steps 50 --batch 8 --seq 128 \\
      --ckpt-dir /tmp/ckpt [--device cpu]

Rerunning the same command resumes from the newest checkpoint in
``--ckpt-dir``; SIGTERM (or SIGINT) lets the step in flight finish, saves,
and exits.  The device is the CUDA card unless ``--device`` says otherwise.
A mesh other than ``1x1`` comes with the scale-out slice.
"""
import argparse
import dataclasses
import json
import os

import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.models import build_model
from repro_torch.models.config import ParallelConfig
from repro_torch.train import OptConfig, build_train_step, init_opt_state
from repro_torch.train.loop import (LoopConfig, PreemptionGuard,
                                    resume_or_init, train_loop)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--remat", default="none",
                    choices=("none", "full", "dots"))
    ap.add_argument("--compression", default="none",
                    choices=("none", "bf16", "int8_ef"))
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL; only 1x1 until the scale-out slice")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--report", default=None, help="write JSON report here")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.mesh != "1x1":
        raise SystemExit(f"--mesh {args.mesh}: a device mesh comes with the "
                         f"scale-out slice (ROADMAP A.8); use --mesh 1x1")
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get_config(args.arch))
    par = ParallelConfig(remat=args.remat, grad_accum=args.grad_accum,
                         grad_compression=args.compression)
    model = build_model(cfg, par, device=args.device)
    opt_cfg = OptConfig(lr=args.lr, total_steps=args.steps,
                        warmup_steps=max(args.steps // 20, 1),
                        compression=args.compression)
    step_fn, _ = build_train_step(model, opt_cfg)

    data_cfg = DataConfig(
        global_batch=args.batch, seq_len=args.seq,
        vocab_size=cfg.vocab_size, seed=args.seed, family=cfg.family,
        num_frames=cfg.encdec.num_frames if cfg.encdec else 0,
        num_patches=cfg.vlm.num_patches if cfg.vlm else 0,
        d_model=cfg.d_model)
    dataset = SyntheticLMDataset(data_cfg).start()
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    def init_fn():
        params = model.init_params(args.seed)
        return params, init_opt_state(params, opt_cfg)

    params, opt_state, start = resume_or_init(ckpt, init_fn)
    if start:
        print(f"[train] resumed from checkpoint at step {start}", flush=True)

    def batch_put(batch):
        return {k: torch.from_numpy(v).to(model.device)
                for k, v in batch.items()}

    def sink(step, rec):
        print(f"[step {step:5d}] loss={rec['loss']:.4f} "
              f"lr={rec.get('lr', 0):.2e} "
              f"gnorm={rec.get('grad_norm', 0):.3f} "
              f"dt={rec['step_time_s'] * 1e3:.0f}ms"
              + (" STRAGGLER" if rec.get("straggler") else ""), flush=True)

    guard = PreemptionGuard()
    loop_cfg = LoopConfig(total_steps=args.steps,
                          checkpoint_every=args.ckpt_every,
                          log_every=args.log_every)
    layout = getattr(model, "param_layout", None)
    try:
        params, opt_state, report = train_loop(
            step_fn, params, opt_state, dataset, loop_cfg, ckpt,
            start_step=start, metrics_sink=sink, preemption=guard,
            batch_put=batch_put,
            save_extra={"param_layout": dataclasses.asdict(layout)}
            if layout is not None else None)
    finally:
        dataset.stop()
        guard.uninstall()
    print(f"[train] done at step {report['final_step']} "
          f"(preempted={report['preempted']}, "
          f"stragglers={len(report['straggler_events'])})", flush=True)
    if args.report:
        os.makedirs(os.path.dirname(args.report) or ".", exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
