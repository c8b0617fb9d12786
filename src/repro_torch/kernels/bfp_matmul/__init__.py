"""Shared-exponent block-floating-point FC matmul: the kernel 4 family."""
