"""The port's distribution layer: :mod:`spmd` (one controller, a thread a
shard, the collectives of the attention pipeline and of expert
parallelism), :mod:`sharding` (the rule tables and ``ShardCtx``),
:mod:`fsdp` (training state sharded over the ranks of a process group),
:mod:`collectives` (int8 error-feedback gradient compression),
:mod:`elastic` (resharding onto a mesh of another size) and
:mod:`straggler` (the bounded-staleness policy)."""
