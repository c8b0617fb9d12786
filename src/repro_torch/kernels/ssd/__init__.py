"""Kernel 6: the chunked Mamba-2 SSD scan."""
