"""Multi-process parallelism, after momentum_tpu/parallel: the reference
parallelizes with a CPU thread pool (dispenso::parallel_for over IK problems
and frames, SURVEY.md §2.9); JAX shards over a device mesh; the port runs
one process a rank of a torch.distributed group:

* `solve_ik_sharded`, `track_poses_sharded`: data parallelism over a batch
  of IK problems or a clip's frames, nothing exchanged during the solve;
* `momentum_tpu_torch.sequence.sharded.solve_sequence_sharded`: a sequence
  solve's frames split over the ranks, SPIKE substructuring for the
  temporal band and an all-reduced universal block (re-exported here).
"""

from momentum_tpu_torch.parallel.batch import (  # noqa: F401
    default_mesh,
    shard_batch,
    solve_ik_sharded,
    track_poses_sharded,
)


def __getattr__(name):
    # sequence.sharded imports this package's collectives, so its entry
    # point is bound on first use rather than at import
    if name == "solve_sequence_sharded":
        from momentum_tpu_torch.sequence.sharded import solve_sequence_sharded

        return solve_sequence_sharded
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
