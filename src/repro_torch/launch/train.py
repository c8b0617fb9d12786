"""Training launcher: ``python -m repro_torch.launch.train --arch
smollm-360m ...``

Runs real steps through :class:`runtime.Trainer`: a reduced config by
default, the published widths with ``--full``.  Runs on the card unless
``--device cpu`` is given (the kernels' plain versions then run).
``--ckpt-dir`` resumes from the newest checkpoint there, the reference's
or the port's (one layout).  ``--mesh`` is refused: the port trains on one
device (ROADMAP Queue 1, item 7d's parallel part).  Every token family
trains, whisper-tiny on the batches' frames and phi-3-vision-4.2b on
their patches.
"""
from __future__ import annotations

import argparse

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
                    help="'DxM' data x model mesh: not ported (one device)")
    ap.add_argument("--rules", default="", help="JSON logical-rule overrides "
                    "(with --mesh; not ported)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.mesh or args.rules:
        raise NotImplementedError(
            "--mesh / --rules: the port trains on one device; meshes come "
            "with ROADMAP Queue 1, item 7d's parallel part")

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    tcfg = TrainerConfig(steps=args.steps, batch=args.batch,
                         seq_len=args.seq_len, base_lr=args.lr,
                         ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                         log_every=max(args.steps // 20, 1))
    tr = Trainer(cfg, tcfg, device=args.device)
    if args.ckpt_dir and tr.restore_latest():
        print(f"resumed from step {int(tr.state['step'])}")
    hist = tr.run()
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
