"""Hillclimb driver of the port, as the JAX package's
``launch/hillclimb.py``: per selected cell, run each candidate variant
through the dry run (``launch.dryrun.run_cell``), print its roofline
terms and append a row to ``hillclimb.jsonl`` in the working directory.

Usage: PYTHONPATH=src python -m repro_torch.launch.hillclimb [cell ...]
Cells: qwen3_sp qwen3_dots qwen3_sp_dots flux_gen_b1 phi_decode phi_nofsdp

The qwen3 cells (``seq_parallel``, ``remat_policy="dots"`` and both)
are costed as the reference costs them, on its production mesh: 256
ranks of (data 16, model 16), the LM train step's tensor parallelism
(``distributed.tensor_parallel``).  ``flux_gen_b1`` (gen_1024 at batch
16) is costed at one rank.  The phi cells vary decode on the same mesh;
serving under a ``model`` axis is not ported (ROADMAP §1), so each is
written as a not-runnable row with its reason (``dryrun.check_runnable``).
"""

from __future__ import annotations

import dataclasses
import json
import sys

from repro_torch.configs import get_config
from repro_torch.launch.dryrun import NotRunnable, run_cell

OUT = "hillclimb.jsonl"
# The reference's make_production_mesh(): (data 16, model 16).
RANKS, MODEL_AXIS = 256, 16


def _write(row) -> None:
    with open(OUT, "a", encoding="utf-8") as f:
        f.write(json.dumps(row) + "\n")


def emit(tag, arch_name, shape_name, arch, ranks: int = 1,
         model_axis: int = 1) -> None:
    """Cost one variant (or record why it cannot run) as a row."""
    try:
        cell = run_cell(arch_name, shape_name, arch=arch, ranks=ranks,
                        model_axis=model_axis, verbose=False)
    except NotRunnable as e:
        _write({"tag": tag, "arch": arch_name, "shape": shape_name,
                "not_runnable": str(e)})
        print(f"[{tag}] not runnable: {e}")
        return
    r = cell.report
    row = cell.row()
    row["tag"] = tag
    _write(row)
    print(f"[{tag}] compute={r.compute_s * 1e3:.1f}ms "
          f"memory={r.memory_s * 1e3:.1f}ms "
          f"collective={r.collective_s * 1e3:.1f}ms "
          f"dominant={r.dominant} useful={r.useful_ratio:.2f} "
          f"mem={r.peak_mem_bytes / 1e9:.1f}GB")


def qwen3_variants(which: str) -> None:
    base = get_config("qwen3-32b")
    train = {"sp": dict(seq_parallel=True), "dots": dict(remat_policy="dots"),
             "sp_dots": dict(seq_parallel=True, remat_policy="dots")}[which]
    tag = {"sp": "seq_parallel", "dots": "remat_dots", "sp_dots": "sp+dots"}
    v = dataclasses.replace(base, train=dataclasses.replace(base.train,
                                                            **train))
    emit(f"qwen3.train_4k.{tag[which]}", "qwen3-32b", "train_4k", v,
         RANKS, MODEL_AXIS)


def flux_gen_variants() -> None:
    base = get_config("flux-dev")
    sh = [dataclasses.replace(s, batch=16) if s.name == "gen_1024" else s
          for s in base.shapes]
    v = dataclasses.replace(base, shapes=tuple(sh))
    emit("flux.gen_1024.batch16", "flux-dev", "gen_1024", v)


def phi_decode_variants(which: str) -> None:
    base = get_config("phi3.5-moe-42b-a6.6b")
    if which == "nofsdp":
        v = dataclasses.replace(base, decode_no_fsdp=True)
        emit("phi.decode_32k.no_fsdp", "phi3.5-moe-42b-a6.6b", "decode_32k",
             v, RANKS, MODEL_AXIS)
    else:
        v = dataclasses.replace(base, decode_replicate_heads=True)
        emit("phi.decode_32k.replicate_heads", "phi3.5-moe-42b-a6.6b",
             "decode_32k", v, RANKS, MODEL_AXIS)


def main(argv=None) -> None:
    cells = (sys.argv[1:] if argv is None else argv) or ["qwen3_sp"]
    for c in cells:
        if c in ("qwen3_sp", "qwen3_dots", "qwen3_sp_dots"):
            qwen3_variants(c.split("_", 1)[1])
        elif c == "flux_gen_b1":
            flux_gen_variants()
        elif c == "phi_decode":
            phi_decode_variants("repheads")
        elif c == "phi_nofsdp":
            phi_decode_variants("nofsdp")
        else:
            raise SystemExit(f"unknown cell {c}")


if __name__ == "__main__":
    main()
