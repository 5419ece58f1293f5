"""End-to-end training driver; counterpart of ``repro.launch.train``.

The reference's flags.  ``--mesh DPxTP`` starts DP x TP ranks, one
process each, joined in one ``torch.distributed`` group on localhost (gloo
when they share a card or run on the CPU, NCCL with one rank per card)
and laid out as the reference's (dp, tp) mesh, TP innermost
(``launch/mesh.mesh_axes``); with tp > 1 the residual stream is sequence
parallel, as the reference's launcher sets it.  The ranks run on the card
unless ``--device cpu`` is given.

Examples:
  # four ranks on one card, internvl2-1b at full width, 2 x 2 mesh:
  PYTHONPATH=src python -m repro_torch.launch.train --arch internvl2-1b \\
      --mesh 2x2 --seq 4096 --batch 2 --steps 3

  # the MoE family, experts split over the TP ranks:
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-moe-1b-a400m --mesh 2x2 --seq 4096 --batch 2 --steps 3

  # CPU rehearsal, smoke config:
  PYTHONPATH=src python -m repro_torch.launch.train --arch internvl2-1b \\
      --smoke --mesh 2x2 --steps 5 --device cpu
"""
from __future__ import annotations

import argparse
import multiprocessing as mp
import socket
import sys

from repro_torch.configs import registry
from repro_torch.dist.collectives import QSyncConfig
from repro_torch.models.config import ModelConfig

PRESETS = {
    "100m": ModelConfig(arch="lm-100m", family="dense", n_layers=12,
                        d_model=768, n_heads=12, n_kv=4, head_dim=64,
                        d_ff=2048, vocab=32768, act="swiglu"),
    "25m": ModelConfig(arch="lm-25m", family="dense", n_layers=8,
                       d_model=384, n_heads=6, n_kv=2, head_dim=64,
                       d_ff=1024, vocab=16384, act="swiglu"),
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--preset", default=None, choices=list(PRESETS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="1x1", help="DPxTP, e.g. 2x2")
    ap.add_argument("--grad-sync", default="lq", choices=["lq", "fp32"])
    ap.add_argument("--q", type=int, default=16)
    ap.add_argument("--bucket", type=int, default=4096)
    ap.add_argument("--rotate", action="store_true")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="resume from and save to this directory "
                         "(default: a fresh directory under TMPDIR)")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def model_config(args) -> ModelConfig:
    if args.preset:
        return PRESETS[args.preset]
    if args.arch:
        cfg = (registry.smoke_config(args.arch) if args.smoke
               else registry.config(args.arch))
        if cfg.family == "encdec":
            # as the reference's launcher: the encoder-decoder trains
            # through models/encdec.make_encdec_loss_fn, not this driver
            raise SystemExit("encdec training driver: use tests/benchmarks "
                             "(frames batch wiring differs)")
        return cfg
    raise SystemExit("pass --arch or --preset")


def run_rank(rank: int, dp: int, tp: int, addr: str, args) -> None:
    """One rank of the (dp, tp) mesh: join the group, build the trainer,
    train."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process, mesh_axes
    from repro_torch.models.sharding import ShardCtx
    from repro_torch.train.data import DataConfig, frames_at
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.trainer import TrainConfig, Trainer

    cfg = model_config(args)
    init_process(rank, dp * tp, addr, device=args.device)
    try:
        dp_axes, tp_axis = mesh_axes((dp, tp))
        ctx = ShardCtx(tp=tp, dp=dp, dp_axes=dp_axes, tp_axis=tp_axis,
                       qcfg=QSyncConfig(q=args.q, bucket=args.bucket,
                                        rotate=args.rotate),
                       grad_sync=args.grad_sync,
                       seq_parallel=tp > 1)
        tc = TrainConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir, log_every=args.log_every,
                         microbatch=args.microbatch)
        opt = OptConfig(lr=args.lr, warmup=min(50, args.steps // 10 + 1),
                        decay_steps=args.steps)
        data = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch)
        b_loc = args.batch // dp
        dp_rank = rank // tp
        rows = (dp_rank * b_loc, (dp_rank + 1) * b_loc)
        extra = None
        if cfg.family == "vlm":
            def extra(step):
                return {"img": frames_at(data, step, cfg.img_tokens,
                                         cfg.d_model, rows=rows,
                                         device=args.device)}
        if rank == 0:
            print(f"[train] arch={cfg.arch} "
                  f"params={cfg.param_count() / 1e6:.1f}M mesh={args.mesh} "
                  f"sync={args.grad_sync}(q={args.q}) steps={args.steps} "
                  f"device={args.device}", flush=True)
        tr = Trainer(cfg, ctx, opt, tc, data, extra_batch=extra,
                     device=args.device)
        state = tr.train()
        if tr.history and rank == 0:
            first, last = tr.history[0], tr.history[-1]
            print(f"[train] loss {first['loss']:.4f} -> {last['loss']:.4f} "
                  f"over {int(state['step'])} steps", flush=True)
        if rank == 0:
            print(f"[train] checkpoints in {tr.tc.ckpt_dir}", flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    args = parse_args(argv)
    model_config(args)                      # fail early on a bad --arch
    dp, tp = (int(v) for v in args.mesh.split("x"))
    if args.batch % dp:
        raise SystemExit(f"--batch {args.batch} does not split over {dp} "
                         f"ranks")
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device; pass --device cpu to train on "
                             "the CPU")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        addr = f"tcp://localhost:{s.getsockname()[1]}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=run_rank, args=(r, dp, tp, addr, args))
             for r in range(dp * tp)]
    for p in procs:
        p.start()
    for p in procs:
        p.join()
    bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        print(f"[train] ranks {bad} failed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
