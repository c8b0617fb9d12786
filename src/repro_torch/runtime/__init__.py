from .trainer import (InjectedFailure, Trainer, TrainerConfig,  # noqa: F401
                      TrainerEvents, reshard_state)
