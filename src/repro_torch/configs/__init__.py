"""Architecture registry of the port: the four LMs (``qwen3-32b``,
``gemma3-4b``, ``qwen2-moe-a2.7b``, ``phi3.5-moe-42b-a6.6b``),
``vdit-paper``, ``dit-xl2``, ``dit-b2``, ``unet-sd15``, ``flux-dev``,
``vit-l16`` and ``efficientnet-b7``: all of the JAX package's."""

from __future__ import annotations

from typing import List

from repro_torch.config.base import ArchConfig
from repro_torch.configs import (dit_b2, dit_xl2, efficientnet_b7, flux_dev,
                                 gemma3_4b, phi3_5_moe, qwen2_moe_a2_7b,
                                 qwen3_32b, unet_sd15, vdit_paper, vit_l16)

_MODULES = {"qwen3-32b": qwen3_32b, "gemma3-4b": gemma3_4b,
            "qwen2-moe-a2.7b": qwen2_moe_a2_7b,
            "phi3.5-moe-42b-a6.6b": phi3_5_moe, "vdit-paper": vdit_paper,
            "dit-xl2": dit_xl2, "dit-b2": dit_b2, "unet-sd15": unet_sd15,
            "flux-dev": flux_dev, "vit-l16": vit_l16,
            "efficientnet-b7": efficientnet_b7}

ALL_ARCHS: List[str] = list(_MODULES)
# The reference's assigned archs, in its order: all but the paper's vDiT.
ASSIGNED_ARCHS: List[str] = ["qwen3-32b", "gemma3-4b", "qwen2-moe-a2.7b",
                             "phi3.5-moe-42b-a6.6b", "dit-xl2", "dit-b2",
                             "flux-dev", "unet-sd15", "vit-l16",
                             "efficientnet-b7"]


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ALL_ARCHS}")
    return _MODULES[name].make_config()


def get_smoke_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ALL_ARCHS}")
    return _MODULES[name].make_smoke_config()
