"""VGG-16 — the second fleet-served CNN (Simonyan & Zisserman 2014).

Same ConvSpec pipeline as AlexNet (``models/alexnet.py`` with
``arch="vgg"``): thirteen 3x3 stride-1 SAME convs, every one on the
Winograd kernels under ``use_pallas``, with fused 2x2/2 max-pools closing
the five stages and no LRN; fc 25088 -> 4096 -> 4096 -> 1000.
``reduced()`` keeps the all-3x3, staged-pool shape at test scale.
"""
from repro_torch.models.alexnet import AlexNetConfig


def config() -> AlexNetConfig:
    return AlexNetConfig(
        name="vgg16",
        arch="vgg",
        image_size=224,
        conv_channels=(64, 64, 128, 128, 256, 256, 256,
                       512, 512, 512, 512, 512, 512),
        pool_after=(2, 4, 7, 10, 13),
        fc_dims=(4096, 4096, 1000),
        num_classes=1000,
    )
