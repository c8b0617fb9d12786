"""Late loss spikes in ``examples/alexnet_winograd.py``'s training loop.

Runs the example's loop (reduced AlexNet, ``synthetic_images(batch=16,
seed=0, steps=60)``, AdamW at lr 3e-3, jitted ``value_and_grad`` of
``alexnet.loss_fn``) from the init seeds ``0 .. --seeds - 1`` and prints,
for each, whether the example's check (the last step's loss under the
first's) holds, the largest loss from step 40 on and the largest rise
from one step to the next over the last 30 steps; ``--every`` prints
every step's loss too.  Once the loss is near 0, AdamW at this rate turns
gradients of float noise into steps of up to lr, and single steps spike.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/alexnet_winograd_spikes.py
        [--seeds 60] [--every]
"""
import argparse
import sys

sys.path.insert(0, "src")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from repro.configs import get_config                        # noqa: E402
from repro.data.pipeline import synthetic_images            # noqa: E402
from repro.models import alexnet                            # noqa: E402
from repro.optim import adamw_step, init_state              # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=60)
    ap.add_argument("--every", action="store_true")
    args = ap.parse_args(argv)
    cfg = get_config("alexnet").reduced()

    @jax.jit
    def step(state, batch):
        (loss, m), g = jax.value_and_grad(alexnet.loss_fn, has_aux=True)(
            state["params"], cfg, batch)
        state, om = adamw_step(state, g, lr=3e-3)
        return state, {**m, **om}

    failed, past_1 = [], []
    for seed in range(args.seeds):
        state = init_state(alexnet.init(jax.random.PRNGKey(seed), cfg))
        losses = []
        for b in synthetic_images(batch=16, image_size=cfg.image_size,
                                  num_classes=cfg.num_classes, seed=0,
                                  steps=60):
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
        late = max(losses[40:])
        rise = max(losses[i] / losses[i - 1] for i in range(30, 60))
        holds = losses[-1] < losses[0]
        failed += [] if holds else [seed]
        past_1 += [seed] if late > 1.0 else []
        print(f"seed {seed:3d}: last < first {holds} ({losses[0]:.4f} -> "
              f"{losses[-1]:.4g}), largest loss from step 40 {late:.4g}, "
              f"largest rise {rise:.4g}x")
        if args.every:
            print("  " + " ".join(f"{x:.4g}" for x in losses))
    print(f"{args.seeds} seeds: the last-step check fails for {failed}; a "
          f"loss past 1.0 from step 40 on for {len(past_1)} ({past_1})")


if __name__ == "__main__":
    main()
