"""AlexNet — the paper's own benchmark topology (Krizhevsky 2012)."""
from repro_torch.models.alexnet import AlexNetConfig


def config() -> AlexNetConfig:
    return AlexNetConfig()
