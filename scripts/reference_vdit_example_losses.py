"""Per-step losses of the JAX package's training example on the CPU.

Runs ``examples/train_vdit.py`` (the ~35 M video DiT, lr 1e-3, warmup
20, remat off, batch 4) unchanged except that its host loop records
every step rather than every 20th.  With ``--seeds N`` it also runs the
same configuration from N - 1 further seeds s = 1, 2, ... (init key s,
data seed s, loop key s + 1; the example itself is s = 0).  Prints one
JSON object: each run's losses and its means over the first and last
20 steps, and those means averaged over the runs:

    PYTHONPATH=src:. JAX_PLATFORMS=cpu \\
        python scripts/reference_vdit_example_losses.py --steps 100 \\
        --seeds 8 --ckpt-dir /tmp/vdit_example_ckpt

The port's ``train[vdit-example]`` phase of ``chip_smoke.py`` holds its
own runs against these means.  Point ``--ckpt-dir`` at an empty
directory: the example resumes from any checkpoint it finds there.
"""

from __future__ import annotations

import argparse
import json
import sys

import jax

from repro.data import synthetic
from repro.launch import workloads
from repro.launch.workloads import build_workload, model_fns
from repro.models.params import init_params
from repro.training import train_loop


def example_losses(argv):
    """The example's own run, every step logged."""
    history = []
    run = train_loop.run_train_loop

    def every_step(*args, **kwargs):
        kwargs["log_every"] = 1
        state, hist = run(*args, **kwargs)
        history.extend(hist)
        return state, hist

    captured = {}

    def capture(arch, *a, **kw):  # the example's config, for the seeds
        captured["arch"] = arch
        return build_workload(arch, *a, **kw)

    train_loop.run_train_loop = every_step
    workloads.build_workload = capture
    try:
        from examples import train_vdit

        sys.argv = ["train_vdit.py"] + argv
        train_vdit.main()
    finally:
        train_loop.run_train_loop = run
        workloads.build_workload = build_workload
    return [h["loss"] for h in history], captured["arch"]


def seeded_losses(arch, steps, seed):
    """The example's loop from ``seed``: init key seed, data seed seed,
    loop key seed + 1, no checkpoints."""
    step = build_workload(arch, "train_64", mesh=None).jitted()
    params = init_params(model_fns(arch), jax.random.PRNGKey(seed))
    state = train_loop.train_state_init(params, arch.train)
    m = arch.model
    g = m.grid(img_res=64)

    def batch_fn(spec, i):
        return synthetic.latent_video_batch(
            spec, i, 4, (g[0] * m.t_patch, g[1] * m.patch, g[2] * m.patch),
            m.in_channels, txt_tokens=m.txt_tokens, txt_dim=m.txt_dim)

    it = synthetic.batch_iterator(batch_fn, synthetic.DataSpec(seed=seed))
    _, history = train_loop.run_train_loop(
        step, state, it, steps, rng=jax.random.PRNGKey(seed + 1),
        log_every=1)
    return [h["loss"] for h in history]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--ckpt-dir", required=True)
    args = ap.parse_args()
    losses, arch = example_losses(["--steps", str(args.steps), "--ckpt-dir",
                                   args.ckpt_dir])
    runs = [losses] + [seeded_losses(arch, args.steps, s)
                       for s in range(1, args.seeds)]

    def means(x):
        return sum(x[:20]) / 20, sum(x[-20:]) / 20

    per_run = [means(r) for r in runs]
    print(json.dumps({
        "steps": args.steps, "runs": runs,
        "mean_first_20": [m[0] for m in per_run],
        "mean_last_20": [m[1] for m in per_run],
        "avg_first_20": sum(m[0] for m in per_run) / len(runs),
        "avg_last_20": sum(m[1] for m in per_run) / len(runs)}))


if __name__ == "__main__":
    main()
