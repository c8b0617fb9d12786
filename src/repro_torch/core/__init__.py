"""Core numerics: Winograd transforms, block floating point, the
analytical models and the device helper.

  winograd  — general Cook-Toom F(m,r) transforms (paper §3.3) and the
              per-layer traffic / work model
  bfp       — shared-exponent block floating point (paper §3.6)
  dse       — analytical resource/throughput models + exploration (paper §4)
  roofline  — the card's peaks and the roofline terms built on them
  opcount   — the dry run's count of a step run on meta tensors
  streambuf — double-buffered host->device prefetch (paper §3.5 analog)
"""
from . import bfp, dse, roofline, streambuf, winograd  # noqa: F401
