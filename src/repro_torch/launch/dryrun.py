"""Dry run of the port: count one rank's step of every (architecture x
input shape) on fake tensors and print the roofline table, with no card.

The JAX package lowers and compiles each cell on 256 or 512 fake TPU
devices and reads XLA's cost analysis.  The port compiles nothing: it
runs the cell's step (``launch.workloads.build_workload``) eagerly under
``FakeTensorMode``, where tensors have shapes, dtypes and strides but no
data, and counts it as it runs:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode``, forward and
  backward, remat's recomputation included (whole-step totals: its
  per-module attribution would keep activations alive);
* bytes: each ATen op's tensor inputs and outputs (a broadcast dim
  counted once; view ops and allocations move none; a gather, an indexed
  write, a copy or a fill only the part it reads or writes), since eager
  PyTorch fuses nothing;
* the hand-written kernels: a fake tensor cannot reach a kernel, so
  inside ``kernels.counting_kernels`` each wrapper records its call with
  ``launch.roofline``'s operations and bytes and returns an empty
  output; where a kernel's work depends on the data (ripple's collapsed
  pairs, sparse's SKIP tiles) the count has nothing skipped;
* collectives: the ``c10d`` calls of one rank of N (a fake process group
  of N ranks, with a fake group for each of the rank's axis groups), as
  ring bytes on the wire a rank over the call's group of n ranks: (n-1)/n
  of an all-gather's output or a reduce-scatter's input, 2(n-1)/n of an
  all-reduce; 0 at one rank.  Those over the model group (tensor
  parallelism's all-reduces, EP's sum, the vocab-parallel cross
  entropy's combine, the all-gathers of pieces that end mid-head, and
  under ``train.seq_parallel`` the sequence all-gathers and
  reduce-scatters) are counted apart from the batch axes' (FSDP's) as
  ``model all-reduce``, ``model all-gather`` and ``model
  reduce-scatter``;
* the per-rank peak: the fake storages alive at once, by their bytes,
  from the start of the step (parameters or their pieces, gradients,
  AdamW moments, activations, caches) to its end.

Python loops show every layer, micro-batch and query chunk to the
counters, so the reference's two-point and unroll probes
(``dryrun.py:87-145``) and ``utils/loops.py`` (``scan_layers``,
``map_chunks``, ``cost_probe_mode``) have nothing to port, and the counts
are of the chunked attention and cross entropy that run (the reference's
``in_cost_probe`` unchunking is not needed).  A train cell runs all of
its micro-batches: the peak is the accumulating step's, and its FLOPs and
bytes are every micro-batch's.

The fake tensors are CPU tensors: autograd on fake CUDA tensors needs a
CUDA build of torch, and the only choices on the step's path that
depend on the device (which attention plan runs, and whether a kernel
wrapper launches) take a counted fake tensor as a card's
(``kernels.on_card``).  The ranks form a (data, model) mesh, data =
ranks / ``--model-axis``: FSDP on ``embed`` over ``data`` and, on a
``model`` axis above 1, the train steps' tensor parallelism
(``distributed.tensor_parallel``: heads, MLP and vocab on ``model``,
EP for the MoEs, ``train.seq_parallel`` for the LM; the DiT's, vDiT's,
MMDiT's and ViT's blocks, attention over query rows where the heads do
not divide the axis).  ``--ranks 256 --model-axis 16`` is the
reference's own (data 16, model 16) production mesh
(``make_production_mesh``).  On a ``model`` axis above 1 the serving
cells and the UNet's and EfficientNet's train cells are not runnable
(ROADMAP §1 items 5 and 4b), and are reported with their reason, not
costed.  A serving cell on N ranks is
the busiest rank's: ceil(batch / N) rows on whole weights.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dit-xl2 \\
        --shape train_256 [--ranks N] [--json out.jsonl]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
        --shape train_4k --ranks 256 --model-axis 16
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--ranks N]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import traceback
from collections import Counter
from typing import Dict, List, Optional

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.config.base import ArchConfig, ShapeSpec
from repro_torch.configs import ALL_ARCHS, ASSIGNED_ARCHS, get_config
from repro_torch.launch import roofline as rl

_aten = torch.ops.aten
# Allocations and a view that its schema does not call one: no bytes move.
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_strided.default,
               _aten.empty_like.default, _aten.new_empty.default,
               _aten.new_empty_strided.default, _aten._unsafe_view.default}
# Ops that read or write only part of their first operand: a gather reads
# the rows it outputs, an indexed write writes the values it is given, a
# copy or fill writes its destination without reading it.
_GATHERS = {_aten.embedding.default, _aten.index_select.default,
            _aten.gather.default, _aten.index.Tensor}
_SCATTERS = {_aten.index_put_.default, _aten.index_copy_.default,
             _aten.index_add_.default, _aten.scatter_.src,
             _aten.scatter_add_.default}
_WRITES = {_aten.copy_.default, _aten.fill_.Scalar, _aten.zero_.default}


class _Whole:
    """``FlopCounterMode``'s module tracker, reduced to the whole step's
    count.  The real one hooks every module call and holds its outputs
    for the backward's attribution, which keeps activations alive until
    the garbage collector runs: the peak would count them."""

    parents = ("Global",)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


def flop_counter():
    """``FlopCounterMode`` counting the step's FLOPs (its registry and
    decompositions) without per-module attribution."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    counter.mod_tracker = _Whole()
    return counter


class NotRunnable(Exception):
    """The cell needs what the port does not run; the message says what."""


def _tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s distinct elements: a broadcast (stride-0) dim
    counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _op_bytes(func, args, kwargs, out) -> int:
    """Bytes one ATen op reads and writes: its tensor inputs and outputs,
    but only the part of the first operand that a gather reads, an
    indexed write writes, or a copy or fill writes."""
    ins, outs = _tensors((args, kwargs)), _tensors(out)
    if func in _GATHERS:
        return sum(map(_tensor_bytes, ins[1:])) + 2 * sum(map(_tensor_bytes, outs))
    if func in _SCATTERS:
        return sum(map(_tensor_bytes, ins[1:])) + _tensor_bytes(ins[-1])
    if func in _WRITES:
        return sum(map(_tensor_bytes, ins))
    return sum(map(_tensor_bytes, ins + outs))


class StepCounter(TorchDispatchMode):
    """Counts a step's ATen traffic and collectives on one rank (while
    :attr:`counting`; those over ``model_group`` apart) and tracks the
    storages alive (always), their peak since :meth:`start`."""

    def __init__(self, model_group=None):
        super().__init__()
        self.model_group = model_group
        self.counting = False
        self.nbytes = 0.0
        self.collectives: Dict[str, float] = {}
        self.live: Dict[int, tuple] = {}   # storage -> (weak ref, bytes)
        self.live_bytes = 0
        self.peak = 0
        self._tracked = 0

    def start(self) -> None:
        """Count from here, and take the peak from what is alive now."""
        self._sweep()
        self.counting = True
        self.peak = self.live_bytes

    def _sweep(self) -> None:
        """Drop the storages whose memory is gone, by a weak reference to
        each C++ storage; swept at a possible new peak and every 256
        allocations, so the peak is exact and the sweeps few."""
        dead = [k for k, (ref, _) in self.live.items() if ref.expired()]
        for k in dead:
            self.live_bytes -= self.live.pop(k)[1]

    def _track(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = s._cdata
        known = self.live.get(key)
        if known is not None:
            if not known[0].expired():
                return
            self.live_bytes -= known[1]  # its address, reused
        self.live[key] = (StorageWeakRef(s), s.nbytes())
        self.live_bytes += s.nbytes()
        self._tracked += 1
        if self.live_bytes > self.peak or self._tracked % 256 == 0:
            self._sweep()
            self.peak = max(self.peak, self.live_bytes)

    def _collective(self, func, args) -> None:
        import torch.distributed as dist

        name = func.__name__.split(".")[0]
        at = {"_allgather_base_": 2, "_reduce_scatter_base_": 2,
              "allreduce_": 1}
        if name not in at:
            raise NotImplementedError(f"the dry run does not count {func}")
        pg = dist.ProcessGroup.unbox(args[at[name]])
        n = pg.size()
        if name == "_allgather_base_":      # (output, input, group, ...)
            kind, wire = "all-gather", _tensor_bytes(args[0]) * (n - 1) / n
        elif name == "_reduce_scatter_base_":  # (output, input, group, ...)
            kind, wire = "reduce-scatter", _tensor_bytes(args[1]) * (n - 1) / n
        else:                               # ([tensors], group, ...)
            kind = "all-reduce"
            wire = sum(map(_tensor_bytes, args[0])) * 2 * (n - 1) / n
        if self.model_group is not None and \
                pg.group_name == self.model_group.group_name:
            kind = "model " + kind
        self.collectives[kind] = self.collectives.get(kind, 0.0) + wire

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.counting:
            if func.namespace == "c10d":
                self._collective(func, args)
            elif not (func.is_view or func in _NO_TRAFFIC
                      or func.namespace == "prim"):  # prim: metadata
                self.nbytes += _op_bytes(func, args, kwargs, out)
        for t in _tensors(out):
            self._track(t)
        return out


@dataclasses.dataclass
class CellReport:
    """A costed cell: the roofline report and what the dry run counted
    beside it."""

    report: rl.RooflineReport
    ranks: int
    kernel_calls: Dict[str, int]
    kernel_bytes: float
    state_bytes: float
    seconds: float

    @property
    def fits(self) -> bool:
        return self.report.peak_mem_bytes <= rl.HBM_BYTES

    def row(self) -> Dict:
        row = self.report.row()
        row.update(ranks=self.ranks, collectives=self.report.collective_breakdown,
                   steps_multiplier=self.report.steps_multiplier,
                   kernel_calls=self.kernel_calls, bound_s=self.report.bound_s,
                   hlo_bytes=self.report.hlo_bytes,
                   state_gb=self.state_bytes / 1e9, fits=self.fits)
        return row


class _Rank0:
    """The device mesh stand-in of rank 0: its coordinate on each axis."""

    def __init__(self, ndim: int):
        self.ndim = ndim

    def get_coordinate(self):
        return [0] * self.ndim


def _rank_mesh(ranks: int, model_axis: int = 1, groups: bool = False):
    """Rank 0 of ``ranks`` ranks as a (data, model) rank mesh on the CPU;
    with ``groups``, inside :func:`_fake_ranks`, with its fake batch and
    model groups (``launch.mesh.axis_groups``, each group made once)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import RankMesh, axis_groups

    shape = (ranks // model_axis, model_axis)
    made = {}
    if groups:
        made = axis_groups(shape, 0, lambda rs: dist.new_group(rs) if 0 in rs
                           else None)
    return RankMesh(("data", "model"), shape, torch.device("cpu"), _Rank0(2),
                    made)


@contextlib.contextmanager
def _fake_ranks(ranks: int, model_axis: int = 1):
    """Rank 0 of a fake process group of ``ranks`` (its collectives do
    nothing; the counter sees each call) and its rank mesh of
    (ranks / model_axis, model_axis); None at one rank."""
    if ranks == 1:
        yield None
        return
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run at several ranks needs a process "
                           "without a process group")
    dist.init_process_group("fake", rank=0, world_size=ranks,
                            store=FakeStore())
    try:
        yield _rank_mesh(ranks, model_axis, groups=True)
    finally:
        dist.destroy_process_group()


def check_runnable(arch: ArchConfig, shape: ShapeSpec, ranks: int,
                   model_axis: int = 1) -> None:
    """Raise :class:`NotRunnable` for a cell that the port does not run on
    ``ranks`` ranks with a ``model`` axis of ``model_axis``, or that they
    cannot split."""
    if ranks % model_axis:
        raise NotRunnable(f"{ranks} ranks do not split over a model axis of "
                          f"{model_axis}")
    if model_axis > 1 and shape.kind != "train":
        raise NotRunnable(
            f"serving ({shape.kind}) under a model axis above 1 is not "
            f"ported (ROADMAP §1 item 5: decode_act_rules' kv_seq on model, "
            f"decode_replicate_heads, decode_no_fsdp)")
    if model_axis > 1:
        from repro_torch.launch.workloads import TP_FAMILIES, model_axis_unported

        if arch.family not in TP_FAMILIES:
            raise NotRunnable(model_axis_unported(arch.family))
    if shape.kind == "train" and arch.train.seq_parallel and model_axis > 1 \
            and shape.seq_len % model_axis:
        raise NotRunnable(f"train.seq_parallel: {shape.seq_len} tokens do not "
                          f"split over a model axis of {model_axis}")
    if shape.kind == "decode" and arch.decode_replicate_heads:
        raise NotRunnable(
            "decode_replicate_heads replicates the query heads over the "
            "model axis; the port's serving runs a model axis of 1 "
            "(ROADMAP §1 item 5)")
    if shape.kind == "decode" and arch.decode_no_fsdp:
        raise NotRunnable(
            "decode_no_fsdp drops FSDP from the decode params; the port's "
            "serving already holds whole weights on every rank, so the "
            "variant is the base cell")
    if shape.kind == "train" and ranks > 1:
        from repro_torch.launch.workloads import (VISION_FAMILIES,
                                                  _effective_accum)

        data = ranks // model_axis
        batch = shape.global_batch if arch.family == "lm" else shape.batch
        accum = max(arch.train.grad_accum, 1)
        if arch.family not in VISION_FAMILIES:
            accum = _effective_accum(accum, batch,
                                     _rank_mesh(ranks, model_axis))
        if batch % accum or (batch // accum) % data:
            raise NotRunnable(
                f"micro-batches of {batch} / {accum} rows do not split over "
                f"{data} data ranks")


def run_cell(arch_name: str, shape_name: str, *, ranks: int = 1,
             model_axis: int = 1, verbose: bool = True,
             cost_probe: bool = True,
             arch: Optional[ArchConfig] = None) -> CellReport:
    """Count one rank's step of (arch x shape) on ``ranks`` ranks, a
    (ranks / model_axis, model_axis) mesh; return its
    :class:`CellReport`.  Raises :class:`NotRunnable` for a cell the port
    does not run.  ``cost_probe=False`` tracks the peak only (no FLOP or
    byte counts)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import counting_kernels
    from repro_torch.launch.workloads import build_workload

    if arch is None:
        arch = get_config(arch_name)
    shape = arch.shape(shape_name)
    check_runnable(arch, shape, ranks, model_axis)
    t0 = time.time()
    flops = flop_counter()
    # The FLOP counter sits below the byte counter, so its decompositions
    # of ops it has no formula for do not reach the byte counter.
    with _fake_ranks(ranks, model_axis) as mesh, FakeTensorMode(), \
            flops if cost_probe else contextlib.nullcontext(), \
            StepCounter(None if mesh is None else
                        mesh.model_group()) as counter, \
            counting_kernels() as calls:
        wl = build_workload(arch, shape_name, mesh, device="cpu")
        flops.flop_counts.clear()
        counter.start()
        state_bytes = counter.live_bytes
        wl.fn(*wl.args)
        counter.counting = False
        peak, steps = counter.peak, wl.steps_multiplier
        del wl
    kernel_s = sum(max(v for k, v in w.terms().items() if k != "bytes")
                   for _, w in calls)
    kernel_bytes = float(sum(w.nbytes for _, w in calls))
    n_params = rl.param_count(arch.model)
    active = (rl.active_params_lm(arch.model) if arch.family == "lm"
              else n_params)
    report = rl.analyze_values(
        float(flops.get_total_flops()), counter.nbytes + kernel_bytes,
        {k: int(v) for k, v in counter.collectives.items()}, arch, shape,
        mesh_desc=f"{ranks // model_axis}x{model_axis}", chips=ranks,
        param_count=n_params,
        active_param_count=active, steps_multiplier=steps,
        kernel_s=kernel_s)
    report.peak_mem_bytes = float(peak)
    cell = CellReport(report, ranks, dict(Counter(n for n, _ in calls)),
                      kernel_bytes, float(state_bytes), time.time() - t0)
    if verbose:
        print_cell(cell)
    return cell


def print_cell(cell: CellReport) -> None:
    r = cell.report
    print(f"--- {r.arch} x {r.shape} on {r.mesh} ranks (data x model), one "
          f"rank's step counted in {cell.seconds:.1f}s"
          + (f"; x{r.steps_multiplier} a request" if r.steps_multiplier > 1
             else ""))
    print(f"    counted: flops={r.hlo_flops:.3e} bytes={r.hlo_bytes:.3e} "
          f"(kernels {cell.kernel_bytes:.3e}); kernel calls "
          f"{cell.kernel_calls or '{}'}")
    print(f"    collectives/rank (bytes on the wire): "
          f"{r.collective_breakdown}")
    print(f"    roofline: compute={r.compute_s * 1e3:.2f}ms "
          f"memory={r.memory_s * 1e3:.2f}ms "
          f"collective={r.collective_s * 1e3:.2f}ms "
          f"-> {r.dominant}-bound; model_flops={r.model_flops:.3e} "
          f"useful={r.useful_ratio:.2f}")
    print(f"    per-rank peak {r.peak_mem_bytes / 1e9:.2f} GB "
          f"({r.peak_mem_bytes / 2**30:.2f} GiB; state at the step's start "
          f"{cell.state_bytes / 1e9:.2f} GB): "
          f"{'fits' if cell.fits else 'does not fit'} the card's "
          f"{rl.HBM_BYTES / 2**30:.0f} GiB")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ALL_ARCHS)
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true",
                    help="run every assigned (arch x shape) cell")
    ap.add_argument("--ranks", type=int, default=1,
                    help="ranks (FSDP on embed over ranks / model-axis of "
                         "them); one rank is counted")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="the mesh's model axis (tensor parallelism of the "
                         "LM, DiT, vDiT, MMDiT and ViT train steps); 16 "
                         "with --ranks 256 is the reference's 16 x 16 mesh")
    ap.add_argument("--json", help="append reports to this JSON-lines file")
    ap.add_argument("--no-probe", action="store_true",
                    help="track the per-rank peak only, no FLOPs or bytes")
    args = ap.parse_args(argv)
    if args.ranks < 1 or args.model_axis < 1:
        ap.error("--ranks and --model-axis must be at least 1")
    if args.ranks % args.model_axis:
        ap.error("--model-axis must divide --ranks")
    desc = f"{args.ranks // args.model_axis}x{args.model_axis}"
    cells = []
    if args.all:
        for a in ASSIGNED_ARCHS:
            for s in get_config(a).shapes:
                cells.append((a, s.name))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        cells.append((args.arch, args.shape))

    failures, skipped = [], []
    for arch_name, shape_name in cells:
        try:
            cell = run_cell(arch_name, shape_name, ranks=args.ranks,
                            model_axis=args.model_axis,
                            cost_probe=not args.no_probe)
            row = cell.row()
        except NotRunnable as e:
            print(f"--- {arch_name} x {shape_name} on {desc} ranks: "
                  f"not runnable: {e}")
            skipped.append((arch_name, shape_name))
            row = {"arch": arch_name, "shape": shape_name,
                   "mesh": desc, "not_runnable": str(e)}
        except Exception as e:  # noqa: BLE001 — report all failures at end
            traceback.print_exc()
            failures.append((arch_name, shape_name, repr(e)))
            continue
        if args.json:
            with open(args.json, "a", encoding="utf-8") as f:
                f.write(json.dumps(row) + "\n")

    print(f"\n=== dry-run complete: {len(cells) - len(failures)}/{len(cells)} "
          f"cells passed ({len(skipped)} of them not runnable) on "
          f"{desc} ranks")
    for f_ in failures:
        print("FAILED:", f_)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
