"""Training launcher: ``python -m repro_torch.launch.train --arch
smollm-360m ...``

Runs real steps through :class:`runtime.Trainer`: a reduced config by
default, the published widths with ``--full``.  Runs on the card unless
``--device cpu`` is given (the kernels' plain versions then run).
``--ckpt-dir`` resumes from the newest checkpoint there, the reference's
or the port's (one layout).  Every token family trains, whisper-tiny on
the batches' frames and phi-3-vision-4.2b on their patches.

``--mesh DxM`` trains on a ("data", "model") mesh of D*M ranks, one
process each, as ``torchrun --nproc-per-node D*M`` starts them (NCCL on
the card, gloo with ``--device cpu``); ``--rules`` overrides the logical
sharding rules (JSON).  NCCL takes one rank a card::

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --mesh 2x2 --device cpu
"""
from __future__ import annotations

import argparse
import json

from ..configs import LM_ARCHS, get_config
from ..runtime import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=LM_ARCHS)
    ap.add_argument("--full", action="store_true",
                    help="the published widths; default reduced")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--mesh", default="",
                    help="'DxM' data x model mesh over the D*M ranks "
                    "torchrun starts")
    ap.add_argument("--rules", default="", help="JSON logical-rule overrides "
                    "(with --mesh)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.rules and not args.mesh:
        ap.error("--rules needs --mesh")

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    tcfg = TrainerConfig(steps=args.steps, batch=args.batch,
                         seq_len=args.seq_len, base_lr=args.lr,
                         ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                         log_every=max(args.steps // 20, 1))
    if not args.mesh:
        return _train(Trainer(cfg, tcfg, device=args.device), args)
    import torch.distributed as dist

    from .mesh import init_process_group, make_mesh
    try:
        d, m = (int(x) for x in args.mesh.split("x"))
    except ValueError:
        ap.error(f"--mesh {args.mesh!r}: expected DxM, e.g. 2x2")
    init_process_group(args.device)
    try:
        world = dist.get_world_size()
        if d * m != world:
            raise SystemExit(f"--mesh {args.mesh}: {d * m} ranks, but "
                             f"torchrun started {world}")
        mesh = make_mesh((d, m), ("data", "model"))
        rules = json.loads(args.rules) if args.rules else None
        tr = Trainer(cfg, tcfg, mesh=mesh, rules=rules, device=args.device)
        quiet = dist.get_rank() != 0
        if not quiet:
            print(f"mesh {args.mesh} (data x model): {world} ranks, "
                  f"{dist.get_backend()}")
        return _train(tr, args, quiet=quiet)
    finally:
        dist.destroy_process_group()


def _train(tr, args, *, quiet=False):
    """Resume, run and (unless ``quiet``: a rank other than 0) print."""
    if args.ckpt_dir and tr.restore_latest() and not quiet:
        print(f"resumed from step {int(tr.state['step'])}")
    hist = tr.run()
    if quiet:
        return hist
    for h in hist:
        print(f"step {h['step']:6d} loss {h['loss']:8.4f} "
              f"acc {h['accuracy']:6.3f} gnorm {h['grad_norm']:8.3f} "
              f"dt {h['dt']*1e3:7.1f}ms")
    if tr.events.stragglers:
        print(f"stragglers detected: {len(tr.events.stragglers)}")
    if tr.events.recoveries:
        print(f"failure recoveries: {tr.events.recoveries}")
    return hist


if __name__ == "__main__":
    main()
