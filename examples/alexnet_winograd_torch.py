"""The paper's own workload end to end on the PyTorch port: AlexNet with
Winograd F(4,3) convs, LRN, pooling and batched FC layers, trained on
synthetic class blobs, plus the per-layer Table-2-style accounting; the
twin of ``examples/alexnet_winograd.py``.

    PYTHONPATH=src python examples/alexnet_winograd_torch.py [--device cpu]
    [--steps 60]

Trains on route ``winograd`` (the plain Winograd transforms, whose
gradient autograd takes); the CUDA kernels of route ``pallas`` serve and
have no backward.  The reference asserts that the last step's loss is
under the first's; this twin asserts it of the last 10 steps' mean: once
the loss is near 0, AdamW at lr 3e-3 spikes on single steps, in the
reference too (``scripts/alexnet_winograd_spikes.py``), and where a spike
lands depends on the order of float sums.  Runs on the card unless
``--device cpu`` is given.
"""
import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch                                                # noqa: E402

from repro_torch.configs import get_config                  # noqa: E402
from repro_torch.core.dse import DLAConfig, alexnet_throughput  # noqa: E402
from repro_torch.data.pipeline import synthetic_images      # noqa: E402
from repro_torch.models import alexnet                      # noqa: E402
from repro_torch.nn.module import tree_leaves               # noqa: E402
from repro_torch.optim import adamw_step, init_state        # noqa: E402


def _batch(b, device):
    return {"images": torch.from_numpy(b["images"]).to(device),
            "labels": torch.from_numpy(b["labels"]).long().to(device)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # --- per-layer accounting (paper Table 2) -----------------------------
    r = alexnet_throughput(DLAConfig(c_vec=8, k_vec=48), system_overhead=.16)
    print("DLA analytical model @ 8x48 (paper: 1020 img/s measured):")
    print(f"  model system throughput: {r['img_per_s']:.0f} img/s")
    for l in r["layers"]:
        print(f"  {l['name']:6s} act={l['act_gflops']:6.0f} GFLOPS  "
              f"eff={l['dsp_eff']*100:5.1f}%")

    # --- real training steps on the reduced topology ----------------------
    cfg = get_config("alexnet").reduced()
    state = init_state(alexnet.init(0, cfg, device=args.device))
    leaves = tree_leaves(state["params"])
    for p in leaves:
        p.requires_grad_()
    data = synthetic_images(batch=16, image_size=cfg.image_size,
                            num_classes=cfg.num_classes, seed=0,
                            steps=args.steps)

    losses = []
    for i, b in enumerate(data):
        loss, m = alexnet.loss_fn(state["params"], cfg,
                                  _batch(b, args.device))
        grads = torch.autograd.grad(loss, leaves)
        adamw_step(state, grads, lr=3e-3)
        if i % 10 == 0:
            print(f"  step {i:3d} loss {m['loss'].item():.4f} "
                  f"acc {float(m['accuracy']):.3f}")
        losses.append(m["loss"].item())
    # the last 10 steps' mean: single steps spike (module docstring)
    first, last = losses[0], sum(losses[-10:]) / len(losses[-10:])
    assert last < first, "AlexNet training must learn the blobs"

    # --- winograd == direct on the trained params --------------------------
    b = next(synthetic_images(batch=4, image_size=cfg.image_size,
                              num_classes=cfg.num_classes, seed=1, steps=1))
    imgs = _batch(b, args.device)["images"]
    with torch.no_grad():
        lw = alexnet.apply(state["params"], cfg, imgs)
        ld = alexnet.apply(state["params"],
                           dataclasses.replace(cfg, use_winograd=False), imgs)
    err = float((lw - ld).abs().max())
    print(f"winograd-vs-direct logits max err after training: {err:.2e}")
    assert err < 1e-3
    print("alexnet_winograd OK")
    return {"throughput": r, "first_loss": first, "last_loss": last,
            "err": err}


if __name__ == "__main__":
    main()
