"""Offline pattern search: classify (layer, head) attention structure.

Runs calibration traffic through the dispatch path, scores every
template in the bank per (layer, head) against reference attention
(PSNR + realized skip rate), classifies heads static vs dynamic, and
persists the versioned assignment artifact (core/patterns.py,
DESIGN.md §16), the JAX package's file format::

    python -m repro_torch.launch.pattern_search --grid 8x16x16 --layers 4 \\
        --heads 8 --steps 3 --prompts 2 --out /tmp/patterns.json

It runs on the CUDA card; ``--device cpu`` runs it on the CPU.  The
flags and the printed lines are the JAX launcher's.

The calibration traffic is synthetic but head-diverse: heads cycle
through temporal (AR(1)-correlated same-site tokens), spatial
(frame-local smoothed tokens), and dynamic (unstructured) characters,
so the search exercises every branch of the tri-branch classification.
It is drawn from a ``torch.Generator`` on the device, so its stream is
the port's own (not jax.random's); real activations go straight to
:func:`repro_torch.core.patterns.search_patterns`.
"""

from __future__ import annotations

import argparse
from typing import Iterator, Optional, Sequence, Tuple

import torch

from repro_torch.core import patterns
from repro_torch.data.synthetic import correlated_video_latents
from repro_torch.utils.device import resolve_device


def _head_traffic(gen: torch.Generator, character: str,
                  grid: Tuple[int, int, int], d: int, gain: float):
    """(1, N, d) q/k for one head of the given character."""
    t, h, w = grid
    n = t * h * w
    dev = gen.device
    if character == "dynamic":
        return (torch.randn((1, n, d), generator=gen, device=dev),
                torch.randn((1, n, d), generator=gen, device=dev))
    if character == "temporal" and t > 1:
        lat = correlated_video_latents(gen, 1, grid, d, temporal_rho=0.998,
                                       spatial_smooth=0)
    else:  # spatial (also the temporal slot's fallback on T=1 grids)
        lat = correlated_video_latents(gen, 1, grid, d, temporal_rho=0.05,
                                       spatial_smooth=3)
    x = gain * lat.reshape(1, n, d)
    noise = 0.05 * torch.randn((1, n, d), generator=gen, device=dev)
    return x, x + noise


def calibration_traffic(*, grid: Tuple[int, int, int], layers: int,
                        heads: int, steps: int, prompts: int, d: int,
                        seed: int = 0, gain: float = 4.0,
                        characters: Tuple[str, ...] = ("temporal",
                                                       "spatial",
                                                       "dynamic"),
                        device="cuda"
                        ) -> Iterator[Tuple[int, torch.Tensor, torch.Tensor,
                                            torch.Tensor]]:
    """Yield (layer, q, k, v) samples, float32 on ``device``, with
    per-head characters held fixed across steps/prompts — static heads
    must present a *stable* winner, dynamic heads must not.  Each sample
    draws from its own generator, seeded from (seed, layer, prompt,
    step) as the reference seeds its keys."""
    kinds = tuple(characters)
    for layer in range(layers):
        for prompt in range(prompts):
            for step in range(steps):
                gen = torch.Generator(device=device)
                gen.manual_seed(seed + 7919 * layer + 101 * prompt + step)
                qs, ks = [], []
                for head in range(heads):
                    character = kinds[(head + layer) % len(kinds)]
                    qh, kh = _head_traffic(gen, character, grid, d, gain)
                    qs.append(qh)
                    ks.append(kh)
                q = torch.stack(qs, dim=1)
                k = torch.stack(ks, dim=1)
                v = torch.randn(q.shape, generator=gen, device=gen.device)
                yield layer, q, k, v


def _parse_dims(text: str, n: int, flag: str) -> Tuple[int, ...]:
    parts = text.lower().split("x")
    if len(parts) != n or not all(p.isdigit() for p in parts):
        raise argparse.ArgumentTypeError(
            f"{flag} wants {n} x-separated ints, got {text!r}")
    return tuple(int(p) for p in parts)


def main(argv: Optional[Sequence[str]] = None) -> patterns.PatternArtifact:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", default="8x16x16",
                    help="TxHxW token grid (T=1 => spatial-only bank)")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--heads", type=int, default=3)
    ap.add_argument("--steps", type=int, default=2,
                    help="calibration denoising steps per prompt")
    ap.add_argument("--prompts", type=int, default=2)
    ap.add_argument("--d", type=int, default=32, help="head dim")
    ap.add_argument("--block", default="128x128",
                    help="BQxBK block shape skip rates are scored at")
    ap.add_argument("--tolerance-db", type=float, default=25.0,
                    help="min PSNR vs reference for a template to win")
    ap.add_argument("--stability", type=float, default=0.6,
                    help="min fraction of samples agreeing on the winner")
    ap.add_argument("--gain", type=float, default=4.0,
                    help="logit sharpening of the structured heads")
    ap.add_argument("--characters", default="temporal,spatial,dynamic",
                    help="comma list of head characters the calibration "
                         "traffic cycles through")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="artifact path (default: REPRO_PATTERN_ARTIFACT "
                         "or the user cache dir)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    grid = _parse_dims(args.grid, 3, "--grid")
    block = _parse_dims(args.block, 2, "--block")
    samples = calibration_traffic(
        grid=grid, layers=args.layers, heads=args.heads, steps=args.steps,
        prompts=args.prompts, d=args.d, seed=args.seed, gain=args.gain,
        characters=tuple(args.characters.split(",")), device=device)
    art = patterns.search_patterns(
        samples, grid, block_shape=block, tolerance_db=args.tolerance_db,
        stability_min=args.stability,
        meta={"traffic": "synthetic", "layers": args.layers,
              "heads": args.heads, "steps": args.steps,
              "prompts": args.prompts, "seed": args.seed})

    for (layer, head), a in sorted(art.heads.items()):
        print(f"L{layer}/H{head}: {a.spec.label:<28} "
              f"{'static ' if a.static else 'dynamic'} "
              f"branch={a.branch:<8} psnr={min(a.psnr_db, 999.0):6.1f}dB "
              f"skip={a.skip_rate:.2f} stability={a.stability:.2f}")
    print(f"static fraction: {art.static_fraction():.2f} "
          f"({len(art.heads)} heads, version {art.version})")
    path = patterns.save_pattern_artifact(art, args.out)
    print(f"wrote {path}")
    return art


if __name__ == "__main__":
    main()
