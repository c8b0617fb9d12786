"""Continuous-batching serving demo of the PyTorch port (paper §3.7
batching, both regimes), the twin of ``examples/serve_batch.py``.

    PYTHONPATH=src python examples/serve_batch_torch.py [--arch llama3.2-3b]
    PYTHONPATH=src python examples/serve_batch_torch.py --arch alexnet \
        --route pallas

LM archs submit a stream of mixed-length requests to the slot-based decode
engine and report the batching amortization (per-step decode time vs
occupancy): the LM analogue of the paper's S_batch=96 FC batching.

``--arch alexnet`` (or ``vgg16``) serves image-classification requests
through the bucketed, double-buffered ``CnnEngine`` (the paper's own
workload) and reports img/s and request latency percentiles (Tables 5-6).
Runs on the card unless ``--device cpu`` is given.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np                                          # noqa: E402

from repro_torch.configs import (CNN_ARCHS, LM_ARCHS,       # noqa: E402
                                 get_config)
from repro_torch.launch.serve import (CNN_ROUTES,           # noqa: E402
                                      serve_images)
from repro_torch.serving import Engine, Request, ServeConfig  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b",
                    choices=LM_ARCHS + CNN_ARCHS)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--data-parallel", action="store_true",
                    help="CNN path: split buckets over the visible devices")
    ap.add_argument("--route", default="auto", choices=CNN_ROUTES,
                    help="CNN path: conv route (pallas = the hand-written "
                         "CUDA kernels end-to-end through CnnEngine)")
    ap.add_argument("--prefetch", default="on", choices=("on", "off"),
                    help="CNN path: the kernels' weight prefetch (the same "
                         "kernel either way on the port; bit-equal)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    if cfg.family == "cnn":
        # the launcher's own image-serving loop (repro_torch.launch.serve)
        done = serve_images(cfg, args)
        assert done == args.requests
        print("serve_batch OK")
        return done

    scfg = ServeConfig(max_batch=args.max_batch, max_len=160,
                       prefill_bucket=16,
                       cross_len=64 if cfg.family == "audio" else 0)
    eng = Engine(cfg, scfg, seed=0, device=args.device)

    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(4, 48))
        req = Request(prompt=rng.integers(1, cfg.vocab_size, plen).tolist(),
                      max_new=args.max_new)
        if cfg.family == "audio":
            req.frames = (rng.standard_normal((64, cfg.d_model)) * 0.1
                          ).astype(np.float32)
        if cfg.family == "vlm":
            req.patches = (rng.standard_normal((cfg.num_patches, 1024)) * 0.1
                           ).astype(np.float32)
        reqs.append(req)
        eng.submit(req)

    t0 = time.perf_counter()
    eng.run_until_done()
    wall = time.perf_counter() - t0
    done = sum(r.done for r in reqs)
    print(f"arch={args.arch}  completed {done}/{len(reqs)} requests "
          f"in {wall:.1f}s")
    print(f"tokens generated: {eng.tokens_generated} "
          f"({eng.decode_steps} batched decode steps, "
          f"avg occupancy "
          f"{eng.tokens_generated/max(eng.decode_steps,1):.2f}/step)")
    print(f"decode throughput: {eng.decode_tokens_per_s:.1f} tok/s "
          f"(weight stream amortized over the batch — paper §3.7)")
    assert done == len(reqs)
    print("serve_batch OK")
    return done


if __name__ == "__main__":
    main()
