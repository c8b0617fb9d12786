"""Model families of the port: the CNN path and the dense LM family."""

_NOT_PORTED = {"ssm": "7b", "hybrid": "7b and 7c", "moe": "7c",
               "audio": "7c", "vlm": "7c"}


def model_for(cfg):
    """Dispatch to the model family implementation."""
    if cfg.family == "cnn":
        from . import alexnet
        return alexnet
    if cfg.family == "dense":
        from . import lm
        return lm
    raise NotImplementedError(
        f"model family {cfg.family!r} is not ported yet (ROADMAP Queue 1, "
        f"item {_NOT_PORTED.get(cfg.family, '7')})")
