"""Layer-level building blocks: pooling/LRN epilogues, conv dispatch, and
the LM layers (norms, RoPE, MLPs, attention, the block stack)."""
