"""Meshes over several processes in the port (``racon_tpu_torch.parallel``:
``distributed_init``, ``is_multihost``, ``to_global``, ``fetch_global``
and the engines' cross-process merge), against the JAX package.

The file is its own worker: ``python tests/test_torch_multihost.py RANK
WORLD PORT`` joins a gloo group of ``WORLD`` processes and holds 4 CPU
slots, so two workers form one 8-slot global mesh (the port of
``tests/multihost_worker.py``, whose JAX test stays behind
``RACON_TPU_SLOW``). Each worker:

- checks ``is_multihost()``, the world size, an 8-slot ``get_mesh`` with
  4 addressable slots, and that ``backends._auto_mesh`` engages a global
  mesh (one slot a process) with no mesh given;
- runs the consensus engine over the mesh on ``multihost_worker``'s tiny
  windows (8 windows, depth 4, 48 bp, rng 7; band 64, 2 rounds, no trim)
  and the aligner on its 16 mutated 120 bp pairs (rng 9, bucket (256,
  128)), CIGARs and breaking points, again on a 3-slot mesh whose ranks
  hold 1 and 2 slots, then again on the 8 slots with K4 routed at
  every band and the sanitizer shadowing every K4 chunk and group with
  K1 through the same merge;
- runs the overlapper (``chain.find_overlaps``, process-local: the JAX
  package's ``auto`` path fails in a group, the port's does not);
- prints one ``RESULT`` line of JSON.

The parent runs the JAX package's single-device engines (``TpuPoaConsensus
(mesh=None)``, ``TpuAligner(mesh=None)`` with its CIGARs and breaking
points) and its overlapper (``chain.find_overlaps``) in one process on
the same inputs, and both ranks' results must equal them exactly.

In one process, :func:`racon_tpu_torch.parallel.sharded_align` given the
flat byte blocks (the form the aligner passes under a mesh, each shard
building its rows on its own device) equals JAX's ``sharded_align`` on
the rows built from the same blocks.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
SLOTS = 4           # CPU slots a process
TIMEOUT_S = 240     # every subprocess's limit


def tiny_windows(cls, wtype, n_windows=8, depth=4, blen=48):
    """``__graft_entry__._tiny_windows`` for either package's Window."""
    rng = np.random.default_rng(7)
    bases = b"ACGT"
    windows = []
    for _ in range(n_windows):
        backbone = bytes(bases[i] for i in rng.integers(0, 4, blen))
        win = cls(0, len(windows), wtype, backbone, b"5" * blen)
        for _ in range(depth):
            layer = bytearray(backbone)
            for p in rng.integers(1, blen - 1, 3):
                layer[p] = bases[int(rng.integers(0, 4))]
            win.add_layer(bytes(layer), b"9" * len(layer), 0, blen - 1)
        windows.append(win)
    return windows


def mutated_pairs():
    """``tests/multihost_worker.py``'s 16 pairs of 120 bp."""
    rng = np.random.default_rng(9)
    bases = b"ACGT"
    pairs = []
    for _ in range(16):
        t = bytes(bases[i] for i in rng.integers(0, 4, 120))
        q = bytearray(t)
        for p in rng.integers(1, 119, 8):
            q[p] = bases[int(rng.integers(0, 4))]
        pairs.append((bytes(q), t))
    return pairs


BP_METAS = [(37 * i, 3 * i) for i in range(16)]
BUCKETS = ((256, 128),)


def overlap_genome():
    """A small simulated genome's reads and draft for the overlapper."""
    from racon_tpu_torch.utils.simulate import simulate
    reads, _, draft, _ = simulate(0.01, seed=5)

    def seqs(blob, step):
        lines = blob.split(b"\n")
        return [lines[i + 1] for i in range(0, len(lines) - 1, step)]
    return seqs(reads, 4), seqs(draft, 2)


def port_overlaps():
    from racon_tpu_torch.ops import chain
    reads, draft = overlap_genome()
    rows = chain.find_overlaps(reads, draft,
                               np.full(len(reads), -1, np.int64),
                               device="cpu")
    return {k: v.tolist() for k, v in rows.items()}


def jax_overlaps():
    from racon_tpu.ops import chain
    reads, draft = overlap_genome()
    rows = chain.find_overlaps(reads, draft,
                               np.full(len(reads), -1, np.int64))
    return {k: np.asarray(v).tolist() for k, v in rows.items()}


def _engines_pass(mesh):
    """The consensus bytes, CIGARs and breaking points over ``mesh``."""
    from racon_tpu_torch import parallel
    from racon_tpu_torch.core.window import Window, WindowType
    from racon_tpu_torch.ops.nw import CudaAligner
    from racon_tpu_torch.ops.poa import CudaPoaConsensus
    windows = tiny_windows(Window, WindowType.TGS)
    eng = CudaPoaConsensus(3, -5, -4, mesh=mesh, band=64, rounds=2)
    flags = eng.run(windows, trim=False)
    assert all(flags), flags
    assert eng.stats["device_windows"] == len(windows), eng.stats
    assert eng.stats["groups"] >= 1
    al = CudaAligner(mesh=mesh, buckets=BUCKETS)
    cigars = al.align_batch(mutated_pairs())
    assert al.stats["device"] == 16, al.stats
    nd = parallel.mesh_size(mesh)
    assert all(B % nd == 0 for *_, B, _ in al.stats["chunk_shapes"])
    bps = CudaAligner(mesh=mesh, buckets=BUCKETS).breaking_points_batch(
        mutated_pairs(), BP_METAS, 50)
    return dict(consensus=[w.consensus.decode() for w in windows],
                cigars=cigars, bp=[np.asarray(a).tolist() for a in bps])


def worker(rank: int, world: int, port: str) -> None:
    import torch
    import torch.distributed as dist

    from racon_tpu_torch import parallel
    from racon_tpu_torch.core import backends
    from racon_tpu_torch.obs import metrics

    torch.set_num_threads(2)
    parallel.distributed_init(f"127.0.0.1:{port}", world, rank)
    parallel.distributed_init(f"127.0.0.1:{port}", world, rank)
    assert parallel.is_multihost() and dist.get_world_size() == world
    assert parallel.process_index() == rank
    cpu = torch.device("cpu")
    mesh = parallel.get_mesh(devices=[cpu] * SLOTS)
    assert parallel.mesh_size(mesh) == SLOTS * world
    assert [k for k, _ in mesh.addressable()] == list(
        range(rank * SLOTS, (rank + 1) * SLOTS))
    assert mesh.owners == tuple(r for r in range(world)
                                for _ in range(SLOTS))
    # no mesh given: the engines engage the global one, a slot a process
    auto = [backends.make_aligner("cuda", 1, device="cpu").mesh,
            backends.make_consensus("cuda", 3, -5, -4, device="cpu").mesh]
    assert [parallel.mesh_size(m) for m in auto] == [world, world]
    assert [len(m.addressable()) for m in auto] == [1, 1]

    metrics.clear("parallel.")
    out = dict(rank=rank, plain=_engines_pass(mesh))
    out["gathers"] = dict(calls=metrics.counter("parallel.gather_calls"),
                          bytes=metrics.counter("parallel.gather_bytes"),
                          seconds=metrics.timer_s("parallel.gather_s"))
    # ranks holding different slot counts (rank r holds r + 1): the
    # merge pads every rank's shards to the largest count
    uneven = parallel.get_mesh(devices=[cpu] * (rank + 1))
    assert uneven.owners == tuple(r for r in range(world)
                                  for _ in range(r + 1))
    out["uneven"] = _engines_pass(uneven)
    # the sanitizer's K1 shadows go through the same merge (the sampler
    # is a counter, so every rank shadows the same chunks and groups); K4
    # is routed at every band (the ladder's narrow rungs included) so
    # that there is a K4 launch to shadow
    from racon_tpu_torch.ops import swar
    swar.FORWARD_KERNEL.update(dict.fromkeys(swar.FORWARD_KERNEL,
                                             "nw_fwd_i16x2"))
    os.environ.update(RACON_TPU_SANITIZE="1", RACON_TPU_SANITIZE_SAMPLE="1")
    metrics.clear()
    out["sanitized"] = _engines_pass(mesh)
    out["shadows"] = [metrics.counter("align.shadow_chunks"),
                      metrics.counter("consensus.shadow_groups")]
    out["overlaps"] = port_overlaps()
    print("RESULT " + json.dumps(out), flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker_env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RACON_TPU_")}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH", "")] if p])
    return env


def _run(args):
    return subprocess.Popen([sys.executable, *args], cwd=ROOT,
                            env=_worker_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)


def _collect(procs, timeout=TIMEOUT_S) -> list:
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _jax_reference():
    from racon_tpu.core.window import Window, WindowType
    from racon_tpu.ops.nw import TpuAligner
    from racon_tpu.ops.poa import TpuPoaConsensus
    windows = tiny_windows(Window, WindowType.TGS)
    TpuPoaConsensus(3, -5, -4, mesh=None, band=64, rounds=2).run(
        windows, trim=False)
    cigars = TpuAligner(mesh=None, buckets=BUCKETS).align_batch(
        mutated_pairs())
    bp = TpuAligner(mesh=None, buckets=BUCKETS).breaking_points_batch(
        mutated_pairs(), BP_METAS, 50)
    return dict(consensus=[w.consensus.decode() for w in windows],
                cigars=cigars, bp=[np.asarray(a).tolist() for a in bp],
                overlaps=jax_overlaps())


def test_two_process_mesh_equals_jax_single_device():
    port = _free_port()
    procs = [_run([__file__, str(rank), "2", str(port)])
             for rank in range(2)]
    try:
        want = _jax_reference()
    finally:
        outs = _collect(procs)
    results = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {rank} failed:\n{out[-4000:]}"
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        results.append(json.loads(line[-1][len("RESULT "):]))
    assert len(want["overlaps"]["q_ord"]) > 10
    assert sum(len(a) for a in want["bp"]) > 16
    for rank, res in enumerate(results):
        assert res["rank"] == rank
        for leg in ("plain", "uneven", "sanitized"):
            for key in ("consensus", "cigars", "bp"):
                assert res[leg][key] == want[key], (rank, leg, key)
        assert min(res["shadows"]) > 0, res["shadows"]
        # one all-gather a chunk and a group at least, every byte counted
        assert res["gathers"]["calls"] >= 3 and res["gathers"]["bytes"] > 0
        assert res["overlaps"] == want["overlaps"], rank
    assert results[0]["gathers"] == {**results[1]["gathers"], "seconds":
                                     results[0]["gathers"]["seconds"]}


_IDEMPOTENT = """
import sys
import torch
import torch.distributed as dist
from racon_tpu_torch import parallel
assert not parallel.is_multihost()
parallel.distributed_init(sys.argv[1], 1, 0)
parallel.distributed_init(sys.argv[1], 1, 0)
assert dist.is_initialized() and dist.get_world_size() == 1
assert not parallel.is_multihost() and parallel.process_index() == 0
mesh = parallel.get_mesh(devices=[torch.device("cpu")] * 3)
assert mesh.owners == (0, 0, 0) and len(mesh.addressable()) == 3
print("IDEMPOTENT OK")
"""


def test_distributed_init_idempotent():
    """The port of ``tests/test_topology.py::
    test_distributed_init_idempotent``: a second call keeps the group (in
    a subprocess, so no group outlives the test in this process)."""
    (out,) = _collect([_run(["-c", _IDEMPOTENT,
                             f"127.0.0.1:{_free_port()}"])])
    assert "IDEMPOTENT OK" in out, out[-4000:]


def test_to_global_and_fetch_global_in_one_process():
    """With one process ``to_global`` is the upload to the mesh's home
    device and ``fetch_global`` each tensor's ``.cpu().numpy()``."""
    import torch

    from racon_tpu_torch import parallel
    from racon_tpu_torch.params import upload
    assert not parallel.is_multihost()
    mesh = parallel.get_mesh(devices=[torch.device("cpu")] * 2)
    assert mesh.home == torch.device("cpu")
    arr = np.arange(24, dtype=np.int16).reshape(6, 4)
    got = parallel.to_global(mesh, arr)
    want = upload(arr, mesh.home)
    assert got.device == want.device and got.dtype == want.dtype
    assert torch.equal(got, want)
    assert torch.equal(parallel.to_global(mesh, got), got)
    tree = [got, torch.ones(3, dtype=torch.bool), torch.tensor(7)]
    fetched = parallel.fetch_global(tree)
    assert all(isinstance(a, np.ndarray) for a in fetched)
    for a, t in zip(fetched, tree):
        assert a.dtype == t.numpy().dtype and np.array_equal(a, t.numpy())


def test_one_process_mesh_keeps_its_single_process_form():
    import torch

    from racon_tpu_torch import parallel
    cpu = torch.device("cpu")
    m = parallel.Mesh((cpu, cpu))
    assert m == parallel.Mesh((cpu, cpu), (0, 0))
    assert hash(m) == hash(parallel.Mesh((cpu, cpu)))
    assert m.addressable() == [(0, cpu), (1, cpu)] and m.home == cpu
    other = parallel.Mesh((cpu, cpu), (0, 1))
    assert other != m and other.addressable() == [(0, cpu)]
    with pytest.raises(ValueError, match="owners"):
        parallel.Mesh((cpu, cpu), (0,))
    # a one-process sharded merge gathers every slot on the first's device
    parts = [(torch.full((2, 3), k), torch.tensor([k, k])) for k in range(3)]
    ops, score = parallel.gather_shards(parts, mesh=parallel.Mesh((cpu,) * 3))
    assert ops.shape == (6, 3) and score.tolist() == [0, 0, 1, 1, 2, 2]


def _byte_blocks(seed, B=8, max_len=256):
    """``B`` mutated pairs as the aligner's flat byte blocks (pair ``k``
    at ``k * max_len``) and their lengths."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    n, m = np.zeros(B, np.int32), np.zeros(B, np.int32)
    qcat = np.zeros(B * max_len, np.uint8)
    tcat = np.zeros(B * max_len, np.uint8)
    for k in range(B):
        t = bases[rng.integers(0, 4, int(rng.integers(40, 200)))]
        q = t.copy()
        flips = rng.random(len(q)) < 0.1
        q[flips] = bases[rng.integers(0, 4, int(flips.sum()))]
        q = np.delete(q, rng.integers(0, len(q), 3))
        n[k], m[k] = len(q), len(t)
        qcat[k * max_len:k * max_len + len(q)] = q
        tcat[k * max_len:k * max_len + len(t)] = t
    return qcat, tcat, n, m


@pytest.mark.parametrize("swar", [False, True])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_sharded_align_from_byte_blocks_equals_jax(k, swar):
    """The aligner's form under a mesh: each shard builds its rows from its
    slice of the byte blocks on its own device."""
    import jax.numpy as jnp
    import torch

    from racon_tpu import parallel as jax_parallel
    from racon_tpu.ops import nw as jax_nw
    from racon_tpu_torch import parallel
    from racon_tpu_torch.ops import nw as tnw
    max_len, band = 256, 128
    qcat, tcat, n, m = _byte_blocks(k + 10 * swar)
    steps = tnw.sweep_bound(int((n + m).max()), max_len)
    jq, jt = jax_nw._build_rows(jnp.asarray(qcat), jnp.asarray(tcat),
                                jnp.asarray(n), jnp.asarray(m),
                                max_len=max_len, band=band)
    want = jax_parallel.sharded_align(
        jax_parallel.get_mesh(k), jq, jt, jnp.asarray(n), jnp.asarray(m),
        max_len=max_len, band=band, steps=steps, use_swar=swar)
    mesh = parallel.get_mesh(devices=[torch.device("cpu")] * k)
    parts = parallel.sharded_align(
        mesh, torch.from_numpy(qcat), torch.from_numpy(tcat),
        torch.from_numpy(n), torch.from_numpy(m), max_len=max_len,
        band=band, steps=steps, packed16=swar)
    assert len(parts) == k and all(p[0].shape[0] == 8 // k for p in parts)
    got = parallel.gather_shards(parts)
    for name, g, w in zip(("ops_packed", "score", "fi", "fj"), got, want):
        assert np.array_equal(g.numpy(), np.asarray(w)), (name, k, swar)


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
