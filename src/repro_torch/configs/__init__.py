"""Architecture registry of the port: ``vdit-paper``, ``dit-xl2``,
``dit-b2``, ``unet-sd15`` and ``flux-dev`` so far."""

from __future__ import annotations

from typing import List

from repro_torch.config.base import ArchConfig
from repro_torch.configs import (dit_b2, dit_xl2, flux_dev, unet_sd15,
                                 vdit_paper)

_MODULES = {"vdit-paper": vdit_paper, "dit-xl2": dit_xl2, "dit-b2": dit_b2,
            "unet-sd15": unet_sd15, "flux-dev": flux_dev}

ALL_ARCHS: List[str] = list(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ALL_ARCHS}")
    return _MODULES[name].make_config()


def get_smoke_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ALL_ARCHS}")
    return _MODULES[name].make_smoke_config()
