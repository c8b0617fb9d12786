"""Model families of the port: the CNN path, the decoder-only LM families
(dense, SSM and mixture-of-experts), the encoder-decoder (``audio``) and
the vision-language model (``vlm``)."""

_NOT_PORTED = {"hybrid": "7c"}


def model_for(cfg):
    """Dispatch to the model family implementation."""
    if cfg.family == "cnn":
        from . import alexnet
        return alexnet
    if cfg.family in ("dense", "ssm", "moe"):
        from . import lm
        return lm
    if cfg.family == "audio":
        from . import encdec
        return encdec
    if cfg.family == "vlm":
        from . import vlm
        return vlm
    raise NotImplementedError(
        f"model family {cfg.family!r} is not ported yet (ROADMAP Queue 1, "
        f"item {_NOT_PORTED.get(cfg.family, '7')})")
