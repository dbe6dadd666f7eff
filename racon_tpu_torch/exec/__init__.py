"""The streaming shard runner: bounded-memory, checkpointed polishing (the
port of ``racon_tpu/exec`` on one device).

A single ``Polisher`` holds every read, overlap and window of a run at
once. This package streams the target contigs through it in shards:

- :mod:`.index`: one metadata pass over the inputs (names and byte spans,
  no payloads) that also replays the polisher's global overlap filter, so
  every shard sees the overlaps a single-shot run keeps;
- :mod:`.planner`: the contigs packed into memory-budgeted shards
  (``--shards``, ``--max-ram``, a target-byte cap) by an LPT over a
  resident-footprint cost model;
- :mod:`.runner`: each shard through ``Polisher.run()`` on one engine pair
  reused by every shard, its part written atomically with its size and
  CRC32, a failed shard walked down the ladder (backoff, device-OOM
  backpressure, the CPU engines when the primary pair is on the host
  already, quarantine), and the parts merged back in target-file order;
- :mod:`.lease`: the O_EXCL lease files by which a worker owns a shard,
  so that several worker processes (``--workers``, or runs launched by
  hand on one work dir) drain one manifest;
- :mod:`.manifest`: the fsync'd checkpoint that lets ``--resume`` skip the
  shards that finished;
- :mod:`.heartbeat`: the progress line.

The contract, held by ``tests/test_torch_exec*.py``: sharded, resumed and
faulted-then-recovered runs, and runs of several workers, write the
single-shot run's bytes. The resident service takes its admission cost
model (:func:`.planner.cached_job_cost`), its journal append
(:func:`.manifest.append_durable`) and its slot type
(:class:`.runner._ChipWorker`) from here. Left out (the JAX package keeps
them): the chip scheduler and mesh shards.
"""

from .index import RunIndex, build_index  # noqa: F401
from .lease import Lease, try_claim, worker_identity  # noqa: F401
from .manifest import (load_manifest, load_shard_states,  # noqa: F401
                       save_manifest)
from .planner import ShardPlan, parse_ram, plan_shards  # noqa: F401
from .runner import ShardRunner  # noqa: F401
