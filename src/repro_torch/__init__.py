"""PyTorch + CUDA port of the serving paths (``repro`` is the JAX
reference): AlexNet image serving and token decode of the dense GQA
language models.  Layout mirrors ``repro``: ``config``, ``configs``,
``core``, ``kernels``, ``nn``, ``models``, ``serving``, ``launch``.  The
hand-written Hopper kernels live in ``csrc/`` and are built with ``nvcc``
at first use."""
