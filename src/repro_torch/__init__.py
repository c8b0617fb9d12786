"""PyTorch + CUDA port of the AlexNet serving path (``repro`` is the JAX
reference).  Layout mirrors ``repro``: ``core``, ``kernels.conv``, ``nn``,
``models``, ``configs``, ``serving``, ``launch``.  The hand-written Hopper
kernels live in ``csrc/`` and are built with ``nvcc`` at first use."""
