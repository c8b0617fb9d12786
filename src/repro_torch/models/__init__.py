"""Model families of the port (the CNN path only, so far)."""


def model_for(cfg):
    """Dispatch to the model family implementation."""
    if cfg.family == "cnn":
        from . import alexnet
        return alexnet
    raise NotImplementedError(
        f"model family {cfg.family!r} is not ported yet (ROADMAP Queue 1, "
        "item 7: the LM, SSM and VLM stack)")
