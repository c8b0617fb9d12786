"""End-to-end example of the PyTorch port: train a ~100M-parameter
llama-family model for a few hundred steps with checkpointing, straggler
telemetry and (simulated) failure recovery, the twin of
``examples/train_100m.py``.

    PYTHONPATH=src python examples/train_100m_torch.py [--steps 300]
    [--device cpu]

The model is a real ~100M config (12 layers, d_model=512, GQA, SwiGLU,
tied embeddings, vocab 49152), not a reduced() toy.  Runs on the card
unless ``--device cpu`` is given.
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.config import ArchConfig                   # noqa: E402
from repro_torch.models import model_for                    # noqa: E402
from repro_torch.nn.module import count_params              # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig      # noqa: E402


def make_100m() -> ArchConfig:
    return ArchConfig(
        name="llama-100m", family="dense",
        num_layers=12, d_model=512, num_heads=8, num_kv_heads=4,
        head_dim=64, d_ff=1536, vocab_size=49_152,
        mlp_type="swiglu", norm_type="rmsnorm", tie_embeddings=True,
        dtype="float32", param_dtype="float32", remat=False)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = make_100m()
    n = count_params(model_for(cfg).init(0, cfg, device="cpu"))
    print(f"model: {cfg.name}  params={n/1e6:.1f}M")

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="train100m_")
    fails = {args.steps // 2}        # simulate one node failure mid-run
    tcfg = TrainerConfig(steps=args.steps, batch=args.batch,
                         seq_len=args.seq_len, base_lr=6e-4, warmup=50,
                         log_every=20, ckpt_every=50, ckpt_dir=ckpt_dir,
                         keep=2)
    trainer = Trainer(cfg, tcfg, device=args.device,
                      failure_injector=lambda s: s in fails and
                      not fails.discard(s))
    if trainer.restore_latest():
        print(f"resumed from step {int(trainer.state['step'])}")
    history = trainer.run()
    for h in history:
        print(f"step {h['step']:5d}  loss {h['loss']:8.4f}  "
              f"acc {h['accuracy']:5.3f}  gnorm {h['grad_norm']:7.3f}  "
              f"{h['dt']*1e3:8.1f} ms")
    print(f"recoveries: {trainer.events.recoveries}")
    print(f"stragglers flagged: {len(trainer.events.stragglers)}")
    print(f"checkpoints in {ckpt_dir}")
    if not history[-1]["loss"] < history[0]["loss"]:
        raise SystemExit("train_100m_torch: the loss did not fall")
    print("train_100m_torch OK")


if __name__ == "__main__":
    main()
