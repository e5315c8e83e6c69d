"""Per-step next-token losses of the JAX package's LM training launcher
on the CPU, for gemma3-4b's smoke config.

Runs what ``python -m repro.launch.train --arch gemma3-4b --shape
train_4k --smoke --batch-override BATCH`` runs (the workload's jitted
train step, the reference init from ``PRNGKey(seed)``, the launcher's
token batches with data seed ``seed``, the loop key ``PRNGKey(seed)``),
with ``train_4k`` cut to ``--seq-len`` tokens and every step recorded,
from seeds 0, 1, ..., ``--seeds`` - 1.  Prints one JSON object: each
run's nll per step, its means over the first and last 20 steps, and
those means averaged over the runs:

    PYTHONPATH=src JAX_PLATFORMS=cpu \\
        python scripts/reference_lm_smoke_losses.py --steps 100 --seeds 8

The port's ``train[lm-smoke learn]`` phase of ``chip_smoke.py`` holds
its own runs, at the same cut, against these averages.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import jax

from repro.configs import get_smoke_config
from repro.data import synthetic
from repro.launch.train import make_batch_fn
from repro.launch.workloads import build_workload, model_fns
from repro.models.params import init_params
from repro.training import train_loop


def seeded_nll(arch, shape, steps, seed):
    """The launcher's loop from ``seed``, every step's nll."""
    step = build_workload(arch, shape.name, mesh=None).jitted()
    params = init_params(model_fns(arch), jax.random.PRNGKey(seed))
    state = train_loop.train_state_init(params, arch.train)
    it = synthetic.batch_iterator(make_batch_fn(arch, shape),
                                  synthetic.DataSpec(seed=seed))
    _, history = train_loop.run_train_loop(
        step, state, it, steps, rng=jax.random.PRNGKey(seed), log_every=1)
    return [h["nll"] for h in history]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args()
    arch = get_smoke_config("gemma3-4b")
    shape = dataclasses.replace(arch.shape("train_4k"), seq_len=args.seq_len,
                                global_batch=args.batch)
    arch = dataclasses.replace(arch, shapes=tuple(
        shape if s.name == shape.name else s for s in arch.shapes))
    runs = [seeded_nll(arch, shape, args.steps, s) for s in range(args.seeds)]
    per_run = [(sum(r[:20]) / 20, sum(r[-20:]) / 20) for r in runs]
    print(json.dumps({
        "steps": args.steps, "seq_len": args.seq_len, "batch": args.batch,
        "runs": runs,
        "mean_first_20": [m[0] for m in per_run],
        "mean_last_20": [m[1] for m in per_run],
        "avg_first_20": sum(m[0] for m in per_run) / len(runs),
        "avg_last_20": sum(m[1] for m in per_run) / len(runs)}))


if __name__ == "__main__":
    main()
