"""Model families of the port: the CNN path, the decoder-only LM families
(dense, SSM, mixture-of-experts and the hybrid of attention and Mamba-2
layers), the encoder-decoder (``audio``) and the vision-language model
(``vlm``)."""


def model_for(cfg):
    """Dispatch to the model family implementation."""
    if cfg.family == "cnn":
        from . import alexnet
        return alexnet
    if cfg.family in ("dense", "ssm", "moe", "hybrid"):
        from . import lm
        return lm
    if cfg.family == "audio":
        from . import encdec
        return encdec
    if cfg.family == "vlm":
        from . import vlm
        return vlm
    raise ValueError(f"unknown model family {cfg.family!r}")
