"""Quickstart of the PyTorch port: train a reduced LM with the full
training stack in about a minute, the twin of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Uses the same ``Trainer`` / data pipeline code paths as the launcher
(``python -m repro_torch.launch.train``); only the config size differs.
Runs on the card unless ``--device cpu`` is given.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs import get_config                  # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig      # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config("smollm-360m").reduced()
    tcfg = TrainerConfig(steps=args.steps, batch=8, seq_len=64, base_lr=3e-3,
                         log_every=10)
    trainer = Trainer(cfg, tcfg, device=args.device)
    history = trainer.run()
    for h in history:
        print(f"step {h['step']:4d}  loss {h['loss']:8.4f}  "
              f"acc {h['accuracy']:5.3f}  {h['dt']*1e3:7.1f} ms/step")
    assert history[-1]["loss"] < history[0]["loss"], "training must learn"
    print("quickstart OK — loss went down on the synthetic affine stream")
    return history


if __name__ == "__main__":
    main()
