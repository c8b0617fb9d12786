"""Model families of the port: the CNN path and the decoder-only LM
families: dense, SSM and mixture-of-experts."""

_NOT_PORTED = {"hybrid": "7c", "audio": "7c", "vlm": "7c"}


def model_for(cfg):
    """Dispatch to the model family implementation."""
    if cfg.family == "cnn":
        from . import alexnet
        return alexnet
    if cfg.family in ("dense", "ssm", "moe"):
        from . import lm
        return lm
    raise NotImplementedError(
        f"model family {cfg.family!r} is not ported yet (ROADMAP Queue 1, "
        f"item {_NOT_PORTED.get(cfg.family, '7')})")
