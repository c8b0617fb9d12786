"""Config registry: ``get_config("alexnet")``.

The port serves the paper's own AlexNet; the reference's other configs
(VGG-16 and the LM architectures) come with later slices of the port.
"""
from __future__ import annotations

from importlib import import_module

_MODULES = {"alexnet": "alexnet"}

CNN_ARCHS = ["alexnet"]


def list_configs():
    return list(_MODULES)


def get_config(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown or not yet ported arch {name!r}; ported: "
                       f"{list(_MODULES)} (see ROADMAP.md for the rest)")
    return import_module(f"repro_torch.configs.{_MODULES[name]}").config()
