"""The port's mesh runtime: :mod:`spmd` (one controller, a thread a
shard, the collectives of the attention pipeline) and :mod:`sharding`
(the axis helpers dispatch reads)."""
