from .checkpoint import (AsyncCheckpointer, CheckpointCorrupt,  # noqa: F401
                         latest_intact_step, latest_step, restore, save,
                         verify_step)
