"""Config registry: ``get_config("smollm-360m")`` etc.

The port serves every config of the reference: the paper's own AlexNet
and VGG-16, the dense GQA language models, the Mamba-2 SSM, the
mixture-of-experts models (GQA or MLA attention), the hybrid jamba
(attention and Mamba-2 layers, MoE in every other layer), the
encoder-decoder whisper-tiny and the vision-language phi-3-vision-4.2b.
"""
from __future__ import annotations

from importlib import import_module

_MODULES = {
    "alexnet": "alexnet",
    "vgg16": "vgg16",
    "smollm-360m": "smollm_360m",
    "llama3.2-3b": "llama3p2_3b",
    "starcoder2-15b": "starcoder2_15b",
    "mamba2-2.7b": "mamba2_2p7b",
    "phi4-mini-3.8b": "phi4_mini_3p8b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "jamba-v0.1-52b": "jamba_v0p1_52b",
    "whisper-tiny": "whisper_tiny",
    "phi-3-vision-4.2b": "phi3_vision_4p2b",
}

CNN_ARCHS = ["alexnet", "vgg16"]
LM_ARCHS = [n for n in _MODULES if n not in CNN_ARCHS]


def list_configs():
    return list(_MODULES)


def get_config(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown or not yet ported arch {name!r}; ported: "
                       f"{list(_MODULES)}")
    return import_module(f"repro_torch.configs.{_MODULES[name]}").config()
