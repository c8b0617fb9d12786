from .adamw import adamw_step, global_norm, init_state, lr_schedule  # noqa: F401
