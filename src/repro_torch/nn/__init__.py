"""Layer-level building blocks: pooling/LRN epilogues and conv dispatch."""
