"""Core numerics: Winograd transforms and the device helper."""
