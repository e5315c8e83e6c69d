"""Parameters of the port's models.

The vDiT's and the DiT's parameters carry the leaf names and per-layer
shapes of the JAX package's ``vdit_defs`` (``repro/models/vdit.py``)
and ``dit_defs`` (``repro/models/dit.py``), in its (d_in, d_out) weight
layout, so a parameter tree crosses between the two packages leaf by
leaf:

* :func:`vdit_param_specs` / :func:`dit_param_specs` — every leaf's
  path, shape and initializer;
* :func:`init_vdit` / :func:`init_dit` — a seeded initialization on a
  device, with ``torch.Generator`` draws;
* :func:`params_from_numpy` — the JAX param tree, passed through numpy
  (``jax.tree_util.tree_map(np.asarray, params)``), as the port's model
  of the config's family.  The JAX tree stacks the blocks' leaves on a
  leading ``num_layers`` dim (scan-over-layers); here it is split per
  layer.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.config.base import DiTConfig, VDiTConfig
from repro_torch.utils.device import resolve_device

# Initializer kinds, as in the JAX defs: 'fan_in' (normal, std
# sqrt(1/fan_in) with fan_in the product of all but the last dim),
# 'normal' (std 0.02: the DiT's label embedding), 'zeros', 'ones'.
Spec = Tuple[Tuple[int, ...], str]


def _linear(d_in, d_out, init="fan_in", bias=True) -> Dict[str, Spec]:
    out = {"w": ((d_in, d_out), init)}
    if bias:
        out["b"] = ((d_out,), "zeros")
    return out


def vdit_block_specs(cfg: VDiTConfig) -> Dict:
    d = cfg.d_model
    hd = d // cfg.num_heads
    ff = int(d * cfg.mlp_ratio)
    return {
        "attn": {"wq": ((d, d), "fan_in"), "wk": ((d, d), "fan_in"),
                 "wv": ((d, d), "fan_in"), "wo": ((d, d), "fan_in"),
                 "q_norm": {"scale": ((hd,), "ones")},
                 "k_norm": {"scale": ((hd,), "ones")}},
        "mlp": {"wi_gate": ((d, ff), "fan_in"), "wi_up": ((d, ff), "fan_in"),
                "wo": ((ff, d), "fan_in")},
        "ada": {"w": ((d, 6 * d), "zeros"), "b": ((6 * d,), "zeros")},
    }


def vdit_param_specs(cfg: VDiTConfig) -> Dict:
    """Nested dict of (shape, init) per leaf; ``blocks`` is per layer."""
    d = cfg.d_model
    in_dim = cfg.t_patch * cfg.patch * cfg.patch * cfg.in_channels
    return {
        "patch": _linear(in_dim, d),
        "txt_proj": _linear(cfg.txt_dim, d),
        "t_mlp1": _linear(256, d),
        "t_mlp2": _linear(d, d),
        "blocks": vdit_block_specs(cfg),
        "final_ada": {"w": ((d, 2 * d), "zeros"), "b": ((2 * d,), "zeros")},
        "final": _linear(d, in_dim, init="zeros"),
    }


def dit_block_specs(cfg: DiTConfig) -> Dict:
    d = cfg.d_model
    ff = int(d * cfg.mlp_ratio)
    return {
        "attn": {"wq": ((d, d), "fan_in"), "wk": ((d, d), "fan_in"),
                 "wv": ((d, d), "fan_in"), "wo": ((d, d), "fan_in")},
        "mlp": {"wi": ((d, ff), "fan_in"), "wo": ((ff, d), "fan_in"),
                "bi": ((ff,), "zeros"), "bo": ((d,), "zeros")},
        "ada": {"w": ((d, 6 * d), "zeros"), "b": ((6 * d,), "zeros")},
    }


def dit_param_specs(cfg: DiTConfig) -> Dict:
    """Nested dict of (shape, init) per leaf; ``blocks`` is per layer."""
    d, p = cfg.d_model, cfg.patch
    out_ch = cfg.in_channels * (2 if cfg.learn_sigma else 1)
    return {
        "patch": _linear(p * p * cfg.in_channels, d),
        "t_mlp1": _linear(256, d),
        "t_mlp2": _linear(d, d),
        "label_embed": ((cfg.num_classes + 1, d), "normal"),
        "blocks": dit_block_specs(cfg),
        "final_ada": {"w": ((d, 2 * d), "zeros"), "b": ((2 * d,), "zeros")},
        "final": _linear(d, p * p * out_ch, init="zeros"),
    }


ModelConfig = Union[VDiTConfig, DiTConfig]


def _family(cfg: ModelConfig):
    """(model class, param specs) of a model config's family."""
    if isinstance(cfg, DiTConfig):
        from repro_torch.models.dit import DiT

        return DiT, dit_param_specs(cfg)
    if isinstance(cfg, VDiTConfig):
        from repro_torch.models.vdit import VDiT

        return VDiT, vdit_param_specs(cfg)
    raise TypeError(f"no port model for config {type(cfg).__name__}")


def iter_specs(tree: Dict, prefix: Tuple[str, ...] = ()
               ) -> Iterator[Tuple[Tuple[str, ...], Spec]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from iter_specs(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _fill(t: torch.Tensor, init: str, generator: torch.Generator,
          zero_init: bool):
    """Fill one leaf in place.  With ``zero_init=False`` the leaves the
    JAX defs initialize to zeros or ones are drawn too, at fan-in scale
    (offset by 1 for norm scales), so no block is the identity."""
    shape = t.shape
    fan = int(np.prod(shape[:-1])) if len(shape) > 1 else int(shape[0])
    std = 0.02 if init == "normal" else (1.0 / max(fan, 1)) ** 0.5
    if init in ("fan_in", "normal") or not zero_init:
        noise = torch.randn(shape, generator=generator, device=t.device,
                            dtype=torch.float32) * std
        base = 1.0 if init == "ones" else 0.0
        t.copy_(noise + base)
    elif init == "zeros":
        t.zero_()
    else:
        t.fill_(1.0)


def _init(cfg: ModelConfig, seed: int, device, dtype, zero_init: bool):
    cls, specs = _family(cfg)
    device = resolve_device(device)
    model = cls(cfg, device=device, dtype=dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    with torch.no_grad():
        for path, (_, init) in iter_specs(specs):
            if path[0] == "blocks":
                for blk in model.blocks:
                    _fill(_get(blk, path[1:]), init, gen, zero_init)
            else:
                _fill(_get(model, path), init, gen, zero_init)
    return model


def init_vdit(cfg: VDiTConfig, *, seed: int = 0, device=None,
              dtype=torch.float32, zero_init: bool = True):
    """A seeded vDiT on ``device`` (default CUDA).  ``zero_init=True``
    follows the JAX defs (zero adaLN, final and bias leaves); ``False``
    randomizes every leaf so the network is not the identity at init."""
    return _init(cfg, seed, device, dtype, zero_init)


def init_dit(cfg: DiTConfig, *, seed: int = 0, device=None,
             dtype=torch.float32, zero_init: bool = True):
    """A seeded DiT on ``device`` (default CUDA).  ``zero_init=True``
    follows the JAX defs, whose zero adaLN-zero and final leaves make
    every block the identity; served and chip runs use ``False``, which
    randomizes every leaf."""
    return _init(cfg, seed, device, dtype, zero_init)


def _get(module, path) -> torch.Tensor:
    obj = module
    for p in path:
        obj = getattr(obj, p)
    return obj


def params_from_numpy(tree: Dict, cfg: ModelConfig, device=None,
                      dtype: Optional[torch.dtype] = torch.float32):
    """The JAX param tree (numpy leaves, float32) as the port's model of
    ``cfg``'s family (VDiT or DiT).  Leaves are copied verbatim, then
    cast to ``dtype`` on ``device`` (default CUDA)."""
    cls, specs = _family(cfg)
    model = cls(cfg, device=resolve_device(device), dtype=dtype)
    with torch.no_grad():
        for path, (shape, _) in iter_specs(specs):
            leaf = tree
            for p in path:
                leaf = leaf[p]
            arr = np.asarray(leaf)
            if path[0] == "blocks":
                if arr.shape != (cfg.num_layers,) + tuple(shape):
                    raise ValueError(f"{'.'.join(path)}: shape {arr.shape} "
                                     f"!= {(cfg.num_layers,) + shape}")
                for i, blk in enumerate(model.blocks):
                    _get(blk, path[1:]).copy_(torch.from_numpy(
                        np.ascontiguousarray(arr[i], np.float32)))
            else:
                if arr.shape != tuple(shape):
                    raise ValueError(f"{'.'.join(path)}: shape {arr.shape} "
                                     f"!= {shape}")
                _get(model, path).copy_(torch.from_numpy(
                    np.ascontiguousarray(arr, np.float32)))
    return model
