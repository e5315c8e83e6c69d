"""Parameters of the port's models.

The vDiT's, the DiT's, the MMDiT's, the UNet's, the ViT's,
EfficientNet's and the LM's parameters carry the leaf names and
per-layer shapes of the JAX package's ``vdit_defs``
(``repro/models/vdit.py``), ``dit_defs`` (``repro/models/dit.py``),
``mmdit_defs`` (``repro/models/mmdit.py``), ``unet_defs``
(``repro/models/unet.py``), ``vit_defs`` (``repro/models/vit.py``),
``effnet_defs`` (``repro/models/efficientnet.py``) and ``lm_defs``
(``repro/models/transformer_lm.py``), in its (d_in, d_out) weight layout,
so a parameter tree crosses between the two packages leaf by leaf.  The
one layout that differs is a convolution's weight: (k, k, c_in, c_out)
in JAX, (c_out, c_in, k, k) in the port, a depthwise (k, k, 1, C) leaf
(C, 1, k, k) (:func:`to_port`).

* :func:`vdit_param_specs` / :func:`dit_param_specs` /
  :func:`mmdit_param_specs` / :func:`unet_param_specs` /
  :func:`vit_param_specs` / :func:`effnet_param_specs` /
  :func:`lm_param_specs` — every leaf's
  path (lists of levels and blocks give integer steps), JAX shape and
  initializer;
* :func:`init_model` — a seeded initialization of any config's family
  on a device, with ``torch.Generator`` draws in the JAX layout;
  :func:`init_vdit` / :func:`init_dit` / :func:`init_mmdit` /
  :func:`init_unet` / :func:`init_vit` / :func:`init_effnet` — the same
  for one family;
* :func:`params_from_numpy` — the JAX param tree, passed through numpy
  (``jax.tree_util.tree_map(np.asarray, params)``), as the port's model
  of the config's family.  The JAX tree stacks the (v)DiT's, the ViT's
  and the LM's blocks' and the MMDiT's double and single blocks' leaves
  on a leading layer dim (scan-over-layers); here it is split per
  layer;
* :func:`jax_tree` / :func:`load_jax_arrays` — the way back and its
  inverse for a checkpoint: a model's leaves (or a tensor kept per
  parameter, such as an optimizer moment) as the JAX tree, and a flat
  ``path -> array`` map of such a tree copied into them.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.config.base import (DiTConfig, EffNetConfig, LMConfig,
                                     MMDiTConfig, UNetConfig, VDiTConfig,
                                     ViTConfig)
from repro_torch.utils.device import resolve_device

# Initializer kinds, as in the JAX defs: 'fan_in' (normal, std
# sqrt(1/fan_in) with fan_in the product of all but the last dim),
# 'fan_in_1' (the same with fan_in dim 1: the MoE's (E, d_in, d_out)
# expert weights), 'normal' (std 0.02: the DiT's label embedding, the
# LM's embedding, head and routers), 'zeros', 'ones'.  The third entry
# is the leaf's logical axes (``distributed.sharding``), one a dim of
# its JAX shape: the JAX def's axes without the stacked ``layers`` dim.
Axes = Tuple[Optional[str], ...]
Spec = Tuple[Tuple[int, ...], str, Axes]

_R = (None,)  # a replicated 1-D leaf (norm scales, adaLN biases)


def _linear(d_in, d_out, init="fan_in", bias=True,
            axes: Axes = ("embed", "mlp")) -> Dict[str, Spec]:
    """The JAX ``linear_defs``: the bias takes the weight's output axis."""
    out = {"w": ((d_in, d_out), init, axes)}
    if bias:
        out["b"] = ((d_out,), "zeros", (axes[1],))
    return out


def _attn(d, inner, kv, qk_norm_dim=0) -> Dict[str, Spec]:
    """The JAX ``attention_defs`` (wq, wk, wv, wo; RMS q/k norms)."""
    out: Dict = {"wq": ((d, inner), "fan_in", ("embed", "heads")),
                 "wk": ((d, kv), "fan_in", ("embed", "kv")),
                 "wv": ((d, kv), "fan_in", ("embed", "kv")),
                 "wo": ((inner, d), "fan_in", ("heads", "embed"))}
    if qk_norm_dim:
        out["q_norm"] = {"scale": ((qk_norm_dim,), "ones", _R)}
        out["k_norm"] = {"scale": ((qk_norm_dim,), "ones", _R)}
    return out


def _gated_mlp(d, ff) -> Dict[str, Spec]:
    return {"wi_gate": ((d, ff), "fan_in", ("embed", "mlp")),
            "wi_up": ((d, ff), "fan_in", ("embed", "mlp")),
            "wo": ((ff, d), "fan_in", ("mlp", "embed"))}


def _mlp_bias(d, ff) -> Dict[str, Spec]:
    return {"wi": ((d, ff), "fan_in", ("embed", "mlp")),
            "wo": ((ff, d), "fan_in", ("mlp", "embed")),
            "bi": ((ff,), "zeros", ("mlp",)), "bo": ((d,), "zeros", ("embed",))}


def _ada(d, n) -> Dict[str, Spec]:
    return {"w": ((d, n * d), "zeros", ("embed", None)),
            "b": ((n * d,), "zeros", _R)}


def vdit_block_specs(cfg: VDiTConfig) -> Dict:
    d = cfg.d_model
    return {"attn": _attn(d, d, d, qk_norm_dim=d // cfg.num_heads),
            "mlp": _gated_mlp(d, int(d * cfg.mlp_ratio)),
            "ada": _ada(d, 6)}


def vdit_param_specs(cfg: VDiTConfig) -> Dict:
    """Nested dict of (shape, init, axes) per leaf; ``blocks`` is per
    layer."""
    d = cfg.d_model
    in_dim = cfg.t_patch * cfg.patch * cfg.patch * cfg.in_channels
    return {
        "patch": _linear(in_dim, d, axes=(None, "embed")),
        "txt_proj": _linear(cfg.txt_dim, d, axes=(None, "embed")),
        "t_mlp1": _linear(256, d),
        "t_mlp2": _linear(d, d, axes=("mlp", "embed")),
        "blocks": vdit_block_specs(cfg),
        "final_ada": _ada(d, 2),
        "final": _linear(d, in_dim, init="zeros", axes=("embed", None)),
    }


def dit_block_specs(cfg: DiTConfig) -> Dict:
    d = cfg.d_model
    return {"attn": _attn(d, d, d),
            "mlp": _mlp_bias(d, int(d * cfg.mlp_ratio)),
            "ada": _ada(d, 6)}


def dit_param_specs(cfg: DiTConfig) -> Dict:
    """Nested dict of (shape, init, axes) per leaf; ``blocks`` is per
    layer."""
    d, p = cfg.d_model, cfg.patch
    out_ch = cfg.in_channels * (2 if cfg.learn_sigma else 1)
    return {
        "patch": _linear(p * p * cfg.in_channels, d, axes=(None, "embed")),
        "t_mlp1": _linear(256, d),
        "t_mlp2": _linear(d, d, axes=("mlp", "embed")),
        "label_embed": ((cfg.num_classes + 1, d), "normal", (None, "embed")),
        "blocks": dit_block_specs(cfg),
        "final_ada": _ada(d, 2),
        "final": _linear(d, p * p * out_ch, init="zeros", axes=("embed", None)),
    }


def _qk_norms(hd) -> Dict:
    return {"q_norm": {"scale": ((hd,), "ones", _R)},
            "k_norm": {"scale": ((hd,), "ones", _R)}}


def mmdit_stream_specs(cfg: MMDiTConfig) -> Dict:
    """One stream of a double block (the JAX ``_stream_defs``)."""
    d = cfg.d_model
    ff = int(d * cfg.mlp_ratio)
    return {
        "mod": _linear(d, 6 * d, init="zeros", axes=("embed", None)),
        "wqkv": ((d, 3 * d), "fan_in", ("embed", "heads")),
        "wo": ((d, d), "fan_in", ("heads", "embed")),
        "mlp_in": ((d, ff), "fan_in", ("embed", "mlp")),
        "mlp_in_b": ((ff,), "zeros", ("mlp",)),
        "mlp_out": ((ff, d), "fan_in", ("mlp", "embed")),
        "mlp_out_b": ((d,), "zeros", ("embed",)),
        **_qk_norms(d // cfg.num_heads),
    }


def mmdit_single_specs(cfg: MMDiTConfig) -> Dict:
    """A single-stream block (the JAX ``_single_defs``)."""
    d = cfg.d_model
    ff = int(d * cfg.mlp_ratio)
    return {
        "mod": _linear(d, 3 * d, init="zeros", axes=("embed", None)),
        "lin1": ((d, 3 * d + ff), "fan_in", ("embed", "heads")),
        "lin1_b": ((3 * d + ff,), "zeros", ("heads",)),
        "lin2": ((d + ff, d), "fan_in", ("heads", "embed")),
        "lin2_b": ((d,), "zeros", ("embed",)),
        **_qk_norms(d // cfg.num_heads),
    }


def mmdit_param_specs(cfg: MMDiTConfig) -> Dict:
    """Nested dict of (shape, init, axes) per leaf; ``double.img``,
    ``double.txt`` and ``single`` are per layer."""
    d, p = cfg.d_model, cfg.patch
    in_dim = p * p * cfg.in_channels
    return {
        "img_in": _linear(in_dim, d, axes=(None, "embed")),
        "txt_in": _linear(cfg.txt_dim, d, axes=(None, "embed")),
        "t_mlp1": _linear(256, d, axes=(None, "embed")),
        "t_mlp2": _linear(d, d, axes=("embed", "embed")),
        "vec_in": _linear(768, d, axes=(None, "embed")),
        "double": {"img": mmdit_stream_specs(cfg),
                   "txt": mmdit_stream_specs(cfg)},
        "single": mmdit_single_specs(cfg),
        "final_mod": _linear(d, 2 * d, init="zeros", axes=("embed", None)),
        "final": _linear(d, in_dim, init="zeros", axes=("embed", None)),
    }


def _conv(k, c_in, c_out, bias=True, depthwise=False) -> Dict[str, Spec]:
    out = {"w": ((k, k, 1, c_in) if depthwise else (k, k, c_in, c_out),
                 "fan_in", (None, None, None, "heads"))}
    if bias:
        out["b"] = ((c_out,), "zeros", ("heads",))
    return out


def _norm(c) -> Dict[str, Spec]:
    return {"scale": ((c,), "ones", _R), "bias": ((c,), "zeros", _R)}


def _resblock_specs(c_in, c_out, t_dim) -> Dict:
    out = {"norm1": _norm(c_in), "conv1": _conv(3, c_in, c_out),
           "temb": _linear(t_dim, c_out, axes=(None, None)),
           "norm2": _norm(c_out), "conv2": _conv(3, c_out, c_out)}
    if c_in != c_out:
        out["skip"] = _conv(1, c_in, c_out)
    return out


def _xformer_specs(c, ctx_dim) -> Dict:
    return {"norm": _norm(c), "proj_in": _conv(1, c, c), "ln1": _norm(c),
            "self_attn": _attn(c, c, c), "ln2": _norm(c),
            "cross_q": ((c, c), "fan_in", ("embed", "heads")),
            "cross_k": ((ctx_dim, c), "fan_in", (None, "heads")),
            "cross_v": ((ctx_dim, c), "fan_in", (None, "heads")),
            "cross_o": ((c, c), "fan_in", ("heads", "embed")),
            "ln3": _norm(c),
            "ff1": ((c, 8 * c), "fan_in", ("embed", "mlp")),
            "ff2": ((4 * c, c), "fan_in", ("mlp", "embed")),
            "proj_out": _conv(1, c, c)}


def unet_param_specs(cfg: UNetConfig) -> Dict:
    """Nested dict of (JAX shape, init, axes) per leaf, ``down`` / ``up``
    and each level's ``res`` / ``attn`` as lists (the JAX
    ``unet_defs``)."""
    from repro_torch.models.unet import skip_channels

    ch = cfg.ch
    t_dim = 4 * ch
    chans = [ch * m for m in cfg.ch_mult]
    specs: Dict = {"t_mlp1": _linear(ch, t_dim, axes=(None, None)),
                   "t_mlp2": _linear(t_dim, t_dim, axes=(None, None)),
                   "conv_in": _conv(3, cfg.in_channels, ch), "down": [], "up": []}
    c_cur = ch
    for lvl, c_out in enumerate(chans):
        level = {"res": [], "attn": []}
        for _ in range(cfg.n_res_blocks):
            level["res"].append(_resblock_specs(c_cur, c_out, t_dim))
            c_cur = c_out
            if 2 ** lvl in cfg.attn_res:
                level["attn"].append(_xformer_specs(c_out, cfg.ctx_dim))
        if lvl < len(chans) - 1:
            level["down"] = _conv(3, c_out, c_out)
        specs["down"].append(level)
    specs["mid"] = {"res1": _resblock_specs(c_cur, c_cur, t_dim),
                    "attn": _xformer_specs(c_cur, cfg.ctx_dim),
                    "res2": _resblock_specs(c_cur, c_cur, t_dim)}
    skips = skip_channels(cfg)
    for lvl in reversed(range(len(chans))):
        c_out = chans[lvl]
        level = {"res": [], "attn": []}
        for _ in range(cfg.n_res_blocks + 1):
            level["res"].append(_resblock_specs(c_cur + skips.pop(), c_out,
                                                t_dim))
            c_cur = c_out
            if 2 ** lvl in cfg.attn_res:
                level["attn"].append(_xformer_specs(c_out, cfg.ctx_dim))
        if lvl > 0:
            level["up"] = _conv(3, c_out, c_out)
        specs["up"].append(level)
    specs["norm_out"] = _norm(ch)
    specs["conv_out"] = _conv(3, ch, cfg.in_channels)
    return specs


def vit_param_specs(cfg: ViTConfig) -> Dict:
    """Nested dict of (shape, init, axes) per leaf; ``blocks`` is per
    layer."""
    d, p = cfg.d_model, cfg.patch
    return {
        "patch": _linear(p * p * cfg.in_channels, d, axes=(None, "embed")),
        "cls": ((1, 1, d), "normal", (None, None, "embed")),
        "blocks": {"ln1": _norm(d), "attn": _attn(d, d, d), "ln2": _norm(d),
                   "mlp": _mlp_bias(d, cfg.d_ff)},
        "ln_f": _norm(d),
        "head": _linear(d, cfg.num_classes, axes=("embed", "vocab")),
    }


def _mbconv_specs(c_in, c_out, expand, kernel) -> Dict:
    c_mid = c_in * expand
    c_se = max(1, c_in // 4)
    out: Dict = {}
    if expand != 1:
        out["expand"] = _conv(1, c_in, c_mid, bias=False)
        out["bn0"] = _norm(c_mid)
    out.update(dw=_conv(kernel, c_mid, c_mid, bias=False, depthwise=True),
               bn1=_norm(c_mid), se_reduce=_conv(1, c_mid, c_se),
               se_expand=_conv(1, c_se, c_mid),
               project=_conv(1, c_mid, c_out, bias=False), bn2=_norm(c_out))
    return out


def effnet_param_specs(cfg: EffNetConfig) -> Dict:
    """Nested dict of (JAX shape, init, axes) per leaf, ``stages`` a list
    of stages, each a list of blocks (the JAX ``effnet_defs``)."""
    from repro_torch.models.efficientnet import effnet_stages, round_filters

    stem_c = round_filters(32, cfg.width_mult)
    head_c = round_filters(1280, cfg.width_mult)
    stages = effnet_stages(cfg)
    return {
        "stem": _conv(3, cfg.in_channels, stem_c, bias=False),
        "stem_bn": _norm(stem_c),
        "stages": [[_mbconv_specs(c_in if i == 0 else c_out, c_out, expand, k)
                    for i in range(repeats)]
                   for expand, c_in, c_out, repeats, _, k in stages],
        "head": _conv(1, stages[-1][2], head_c, bias=False),
        "head_bn": _norm(head_c),
        "classifier": _linear(head_c, cfg.num_classes, axes=(None, "vocab")),
    }


def lm_block_specs(cfg: LMConfig) -> Dict:
    """One LM block (the JAX ``_block_defs``)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    out: Dict = {"attn_norm": {"scale": ((d,), "ones", _R)},
                 "attn": _attn(d, cfg.num_heads * hd, cfg.num_kv_heads * hd,
                               qk_norm_dim=hd if cfg.qk_norm else 0),
                 "mlp_norm": {"scale": ((d,), "ones", _R)}}
    m = cfg.moe
    if m is None:
        out["mlp"] = _gated_mlp(d, cfg.d_ff)
        return out
    E, Fw = m.num_experts, m.expert_ffw_dim
    out["moe"] = {"router": ((d, E), "normal", ("embed", None)),
                  "wi_gate": ((E, d, Fw), "fan_in_1", ("expert", "embed", None)),
                  "wi_up": ((E, d, Fw), "fan_in_1", ("expert", "embed", None)),
                  "wo": ((E, Fw, d), "fan_in_1", ("expert", None, "embed"))}
    if m.num_shared_experts:
        out["moe"]["shared"] = {**_gated_mlp(d, Fw * m.num_shared_experts),
                                "gate": ((d, 1), "normal", ("embed", None))}
    return out


def lm_param_specs(cfg: LMConfig) -> Dict:
    """Nested dict of (shape, init, axes) per leaf; ``blocks`` is per
    layer."""
    specs = {"embed": ((cfg.vocab_size, cfg.d_model), "normal",
                       ("vocab", "embed")),
             "blocks": lm_block_specs(cfg),
             "final_norm": {"scale": ((cfg.d_model,), "ones", _R)}}
    if not cfg.tie_embeddings:
        specs["lm_head"] = ((cfg.d_model, cfg.vocab_size), "normal",
                            ("embed", "vocab"))
    return specs


ModelConfig = Union[VDiTConfig, DiTConfig, MMDiTConfig, UNetConfig, ViTConfig,
                    EffNetConfig, LMConfig]


def _family(cfg: ModelConfig):
    """(model class, param specs) of a model config's family."""
    if isinstance(cfg, MMDiTConfig):
        from repro_torch.models.mmdit import MMDiT

        return MMDiT, mmdit_param_specs(cfg)
    if isinstance(cfg, UNetConfig):
        from repro_torch.models.unet import UNet

        return UNet, unet_param_specs(cfg)
    if isinstance(cfg, DiTConfig):
        from repro_torch.models.dit import DiT

        return DiT, dit_param_specs(cfg)
    if isinstance(cfg, VDiTConfig):
        from repro_torch.models.vdit import VDiT

        return VDiT, vdit_param_specs(cfg)
    if isinstance(cfg, ViTConfig):
        from repro_torch.models.vit import ViT

        return ViT, vit_param_specs(cfg)
    if isinstance(cfg, EffNetConfig):
        from repro_torch.models.efficientnet import EfficientNet

        return EfficientNet, effnet_param_specs(cfg)
    if isinstance(cfg, LMConfig):
        from repro_torch.models.transformer_lm import TransformerLM

        return TransformerLM, lm_param_specs(cfg)
    raise TypeError(f"no port model for config {type(cfg).__name__}")


def _stacked(cfg: ModelConfig) -> Tuple[Tuple, ...]:
    """Spec path prefixes of the subtrees the JAX tree stacks on a leading
    layer dim (the port's module there is a per-layer list)."""
    if isinstance(cfg, MMDiTConfig):
        return (("double", "img"), ("double", "txt"), ("single",))
    if isinstance(cfg, (VDiTConfig, DiTConfig, ViTConfig, LMConfig)):
        return (("blocks",),)
    return ()


def _leaves(model, cfg: ModelConfig, specs):
    """(path, spec, tensors, stacked) of every leaf: under a stacked
    subtree its tensor in each layer, else its one tensor."""
    for path, spec in iter_specs(specs):
        pre = next((p for p in _stacked(cfg) if path[:len(p)] == p), None)
        if pre is None:
            yield path, spec, [_get(model, path)], False
        else:
            yield path, spec, [_get(blk, path[len(pre):])
                               for blk in _get(model, pre)], True


def iter_specs(tree, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, Spec]]:
    """(path, spec) of every leaf; a list's items are path steps 0, 1, …"""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            yield from iter_specs(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def to_port(arr: torch.Tensor) -> torch.Tensor:
    """A leaf in the JAX layout as the port keeps it: a (k, k, c_in,
    c_out) convolution weight as (c_out, c_in, k, k) (a depthwise (k, k,
    1, C) one as (C, 1, k, k)); any other leaf as it is."""
    return arr.permute(3, 2, 0, 1) if arr.dim() == 4 else arr


def _fill(t: torch.Tensor, shape, init: str, generator: torch.Generator,
          zero_init: bool):
    """Fill one leaf in place from a draw of its JAX ``shape``.  With
    ``zero_init=False`` the leaves the JAX defs initialize to zeros or
    ones are drawn too, at fan-in scale (offset by 1 for norm scales), so
    no block is the identity."""
    if init == "fan_in_1":
        fan = int(shape[1])
    else:
        fan = int(np.prod(shape[:-1])) if len(shape) > 1 else int(shape[0])
    std = 0.02 if init == "normal" else (1.0 / max(fan, 1)) ** 0.5
    if init in ("fan_in", "fan_in_1", "normal") or not zero_init:
        noise = torch.randn(shape, generator=generator, device=t.device,
                            dtype=torch.float32) * std
        base = 1.0 if init == "ones" else 0.0
        t.copy_(to_port(noise + base))
    elif init == "zeros":
        t.zero_()
    else:
        t.fill_(1.0)


def init_model(cfg: ModelConfig, *, seed: int = 0, device=None,
               dtype=torch.float32, zero_init: bool = True):
    """A seeded model of ``cfg``'s family on ``device`` (default CUDA);
    the per-family ``init_*`` below are this call with that family's
    config.  ``zero_init`` as theirs."""
    cls, specs = _family(cfg)
    device = resolve_device(device)
    model = cls(cfg, device=device, dtype=dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    with torch.no_grad():
        for _, (shape, init, _), tensors, _ in _leaves(model, cfg, specs):
            for t in tensors:
                _fill(t, shape, init, gen, zero_init)
    return model


def init_vdit(cfg: VDiTConfig, *, seed: int = 0, device=None,
              dtype=torch.float32, zero_init: bool = True):
    """A seeded vDiT on ``device`` (default CUDA).  ``zero_init=True``
    follows the JAX defs (zero adaLN, final and bias leaves); ``False``
    randomizes every leaf so the network is not the identity at init."""
    return init_model(cfg, seed=seed, device=device, dtype=dtype,
                      zero_init=zero_init)


def init_dit(cfg: DiTConfig, *, seed: int = 0, device=None,
             dtype=torch.float32, zero_init: bool = True):
    """A seeded DiT on ``device`` (default CUDA).  ``zero_init=True``
    follows the JAX defs, whose zero adaLN-zero and final leaves make
    every block the identity; served and chip runs use ``False``, which
    randomizes every leaf."""
    return init_model(cfg, seed=seed, device=device, dtype=dtype,
                      zero_init=zero_init)


def init_mmdit(cfg: MMDiTConfig, *, seed: int = 0, device=None,
               dtype=torch.float32, zero_init: bool = True):
    """A seeded MMDiT on ``device`` (default CUDA).  ``zero_init=True``
    follows the JAX defs, whose zero ``mod``, ``final_mod`` and
    ``final`` leaves make the output 0; served and chip runs use
    ``False``, which randomizes every leaf."""
    return init_model(cfg, seed=seed, device=device, dtype=dtype,
                      zero_init=zero_init)


def init_unet(cfg: UNetConfig, *, seed: int = 0, device=None,
              dtype=torch.float32, zero_init: bool = True):
    """A seeded UNet on ``device`` (default CUDA).  ``zero_init=True``
    follows the JAX defs (zero biases, unit norm scales); served and chip
    runs use ``False``, which randomizes every leaf."""
    return init_model(cfg, seed=seed, device=device, dtype=dtype,
                      zero_init=zero_init)


def init_vit(cfg: ViTConfig, *, seed: int = 0, device=None,
             dtype=torch.float32, zero_init: bool = True):
    """A seeded ViT on ``device`` (default CUDA).  ``zero_init=True``
    follows the JAX defs (zero biases, unit norm scales); chip runs use
    ``False``, which randomizes every leaf."""
    return init_model(cfg, seed=seed, device=device, dtype=dtype,
                      zero_init=zero_init)


def init_effnet(cfg: EffNetConfig, *, seed: int = 0, device=None,
                dtype=torch.float32, zero_init: bool = True):
    """A seeded EfficientNet on ``device`` (default CUDA).
    ``zero_init=True`` follows the JAX defs (zero biases, unit norm
    scales); chip runs use ``False``, which randomizes every leaf."""
    return init_model(cfg, seed=seed, device=device, dtype=dtype,
                      zero_init=zero_init)


def _get(module, path) -> torch.Tensor:
    """The tensor (or module) at a leaf path; a module's ``leaf_aliases``
    names the attribute that holds a path step whose name it cannot
    take."""
    obj = module
    for p in path:
        if isinstance(p, int):
            obj = obj[p]
        else:
            obj = getattr(obj, getattr(obj, "leaf_aliases", {}).get(p, p))
    return obj


def params_from_numpy(tree: Dict, cfg: ModelConfig, device=None,
                      dtype: Optional[torch.dtype] = torch.float32):
    """The JAX param tree (numpy leaves, float32) as the port's model of
    ``cfg``'s family (VDiT, DiT, MMDiT, UNet, ViT, EfficientNet or
    TransformerLM).
    Leaves are copied verbatim (convolution weights transposed to the
    port's layout), then cast to ``dtype`` on ``device`` (default
    CUDA)."""
    cls, _ = _family(cfg)
    model = cls(cfg, device=resolve_device(device), dtype=dtype)
    load_jax_arrays(model, {"/".join(str(p) for p in path): np.asarray(a)
                            for path, a in iter_specs(tree)})
    return model


def from_port(t: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`to_port`: a convolution weight back in the
    JAX (k, k, c_in, c_out) layout (a view); any other leaf as it is."""
    return t.permute(2, 3, 1, 0) if t.dim() == 4 else t


def _nest(flat: Dict[Tuple, torch.Tensor]):
    """{path: leaf} -> nested dicts, a level whose keys are 0..n-1 a
    list."""
    root: Dict = {}
    for path, leaf in flat.items():
        node = root
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(isinstance(k, int) for k in out):
            return [out[i] for i in range(len(out))]
        return out

    return listify(root)


def jax_tree(model, tensor_of=None) -> Dict:
    """The model's leaves as the JAX param tree of its config's family:
    its paths, its layout (convolution weights as views in the JAX
    layout) and, under a stacked subtree, the per-layer tensors stacked
    on a leading dim into a new CPU tensor.  ``tensor_of(param)`` gives
    the tensor to place for each parameter instead of the parameter
    itself (an optimizer moment or EMA copy of the same shape)."""
    cfg = model.cfg
    _, specs = _family(cfg)
    pick = tensor_of or (lambda t: t)
    flat = {}
    for path, _, tensors, stacked in _leaves(model, cfg, specs):
        ts = [pick(t).detach() for t in tensors]
        flat[path] = (torch.stack([t.to("cpu") for t in ts]) if stacked
                      else from_port(ts[0]))
    return _nest(flat)


def load_jax_arrays(model, arrays: Dict[str, np.ndarray], prefix: str = "",
                    tensor_of=None) -> None:
    """Copy a flat ``path -> array`` map of a JAX param tree (keys
    ``prefix/`` + the leaf path joined by ``/``, as a checkpoint stores
    them) into the model's leaves, or into ``tensor_of(param)`` for each
    parameter.  Every leaf must be present, at the JAX shape."""
    cfg = model.cfg
    _, specs = _family(cfg)
    pick = tensor_of or (lambda t: t)
    with torch.no_grad():
        for path, (shape, _, _), tensors, stacked in _leaves(model, cfg,
                                                          specs):
            key = "/".join([prefix] * bool(prefix) + [str(p) for p in path])
            if key not in arrays:
                raise KeyError(f"missing leaf {key!r}")
            arr = np.asarray(arrays[key])
            want = ((len(tensors),) if stacked else ()) + tuple(shape)
            if arr.shape != want:
                raise ValueError(f"{key}: shape {arr.shape} != {want}")
            for t, a in zip(tensors, arr if stacked else (arr,)):
                a = torch.from_numpy(np.ascontiguousarray(a))
                pick(t).copy_(a if stacked else to_port(a))


def logical_axes(cfg: ModelConfig) -> Dict:
    """The logical-axes tree of ``cfg``'s family (the JAX
    ``logical_axes(defs)``, each stacked leaf's leading ``layers`` axis
    dropped: the port keeps a list of layers), in the JAX layout."""
    _, specs = _family(cfg)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return tree[2]

    return walk(specs)


def port_axes(axes: Axes) -> Axes:
    """A leaf's logical axes in the port's layout (:func:`to_port`: a
    convolution weight's (k, k, c_in, c_out) axes as (c_out, c_in, k,
    k))."""
    return tuple(axes[i] for i in (3, 2, 0, 1)) if len(axes) == 4 else axes


def param_axes(model) -> list:
    """The logical axes of each of ``model.parameters()``, in order and in
    the port's layout (what a rule table shards a parameter by)."""
    _, specs = _family(model.cfg)
    by_id = {}
    for _, (_, _, axes), tensors, _ in _leaves(model, model.cfg, specs):
        for t in tensors:
            by_id[id(t)] = port_axes(axes)
    return [by_id[id(p)] for p in model.parameters()]
