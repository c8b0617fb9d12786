"""The conv kernel family: direct, Winograd and fused Winograd."""
