"""Multi-process launch and the port's collectives, on torch.distributed.

Port of rattle_tpu/parallel/launch.py.  The JAX package lets XLA's SPMD
partitioner split its jitted programs over a global device mesh; PyTorch has
no such partitioner, so the port makes the decomposition explicit: one
process a rank, one device a rank, and the process group is the mesh.

* each rank calls :func:`init_distributed`, which reads the JAX package's
  launch contract from the environment:

    RATTLE_COORDINATOR    host:port of rank 0 (``tcp://host:port``)
    RATTLE_NUM_PROCESSES  the world size
    RATTLE_PROCESS_ID     this process's rank

  With none of them set the run is single-process;
* the backend is gloo on host tensors.  Everything the cluster path
  exchanges is host data in the JAX package too (the decisions, the replay
  vectors, the read sequences of the rare host rescore), and host tensors let
  several ranks share one card, which NCCL refuses;
* the group has an explicit timeout: a rank that dies makes the others
  fail, never hang.

Every collective of the port lives in this module and adds to ``STATS``
(calls, payload bytes sent and received, seconds spent inside them).

``run_ranks`` starts a command as the ranks of one group on this host, each
under one deadline; ``python -m rattle_tpu_torch.parallel.launch -n N --
MODE ARGS`` runs the port's CLI so (see ``main``).
"""

from __future__ import annotations

import argparse
import atexit
import datetime
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve

DEFAULT_TIMEOUT_S = 600.0

STATS = {"calls": 0, "bytes_sent": 0, "bytes_recv": 0, "seconds": 0.0}


def reset_stats() -> None:
    """Set every collective counter to 0."""
    for k in STATS:
        STATS[k] = 0.0 if k == "seconds" else 0


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     timeout_s: Optional[float] = None) -> bool:
    """Join the gloo process group from the arguments or the environment.

    Returns True when the run is multi-process (also when the group was
    already joined); no arguments and no ``RATTLE_COORDINATOR`` mean a
    single-process run (False).  ``timeout_s`` (default
    ``RATTLE_TIMEOUT_S`` or 600) bounds the rendezvous and every
    collective."""
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "RATTLE_COORDINATOR")
    if coordinator_address is None:
        return False
    num_processes = int(num_processes or os.environ["RATTLE_NUM_PROCESSES"])
    process_id = int(process_id if process_id is not None
                     else os.environ["RATTLE_PROCESS_ID"])
    if timeout_s is None:
        timeout_s = float(os.environ.get("RATTLE_TIMEOUT_S",
                                         DEFAULT_TIMEOUT_S))
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    atexit.register(_destroy)
    return True


def _destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


_world = process_count   # process_shard_bounds's argument shadows the name


def process_shard_bounds(n_items: int, process_id: Optional[int] = None,
                         process_count: Optional[int] = None
                         ) -> Tuple[int, int]:
    """[start, end) of this process's contiguous slice of ``n_items``.

    Slices are balanced to within one item; every process computes every
    bound deterministically (no communication)."""
    pc = process_count if process_count is not None else _world()
    pid = process_id if process_id is not None else process_index()
    base, extra = divmod(n_items, pc)
    start = pid * base + min(pid, extra)
    end = start + base + (1 if pid < extra else 0)
    return start, end


@dataclass(frozen=True)
class DataMesh:
    """The engine's reads axis: ``world`` ranks, this one ``rank``, on
    ``device``."""

    world: int
    rank: int
    device: torch.device


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda`` resolves to ``cuda:{rank % cards}``
    (several ranks may share a card) and becomes the current device; it
    raises without a card.  ``cpu`` stays the CPU."""
    dev = resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", process_index() % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def data_mesh(device="cuda") -> DataMesh:
    """The mesh of every rank of the process group (one rank when the run
    is single-process)."""
    return DataMesh(process_count(), process_index(), rank_device(device))


def _timed(fn, sent: int):
    t0 = time.perf_counter()
    out = fn()
    STATS["seconds"] += time.perf_counter() - t0
    STATS["calls"] += 1
    STATS["bytes_sent"] += sent
    return out


def allgather_to_hosts(x: np.ndarray) -> np.ndarray:
    """Every rank's ``x`` concatenated along axis 0, in rank order, on every
    rank.  The arrays may differ in length along axis 0 (the lengths are
    exchanged first, then every rank sends its rows padded to the longest);
    their other dimensions and dtype must agree."""
    x = np.ascontiguousarray(x)
    world = process_count()
    if world == 1:
        return x.copy()
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    mine = torch.tensor([x.shape[0]], dtype=torch.int64)
    _timed(lambda: dist.all_gather(sizes, mine), 8)
    counts = [int(c) for c in sizes]
    m = max(max(counts), 1)     # gloo takes no empty buffers
    buf = torch.from_numpy(pad_rows(x, m).reshape(m, -1).view(np.uint8))
    got = [torch.empty_like(buf) for _ in range(world)]
    _timed(lambda: dist.all_gather(got, buf), x.nbytes)
    STATS["bytes_recv"] += sum(counts) * buf.shape[1] - x.nbytes
    flat = np.concatenate([g.numpy()[:c] for g, c in zip(got, counts)])
    return flat.view(x.dtype).reshape(-1, *x.shape[1:])


def allgather_objects(obj) -> List:
    """Every rank's picklable ``obj``, in rank order, on every rank."""
    world = process_count()
    if world == 1:
        return [obj]
    out: List = [None] * world
    size = len(pickle.dumps(obj))
    _timed(lambda: dist.all_gather_object(out, obj), size)
    STATS["bytes_recv"] += sum(len(pickle.dumps(o)) for o in out) - size
    return out


def barrier() -> None:
    if process_count() > 1:
        _timed(dist.barrier, 0)


def pad_rows(arr: np.ndarray, rows: int, fill=0) -> np.ndarray:
    out = np.full((rows, *arr.shape[1:]), fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


# --------------------------------------------------------------------------
# starting ranks on one host
# --------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(cmd: Sequence[str], world: int, timeout_s: float,
              env: Optional[Dict[str, str]] = None,
              cwd: Optional[str] = None) -> List[Tuple[int, str, str]]:
    """Run ``cmd`` as ranks 0..world-1 of one process group on this host
    (the RATTLE_* variables set, rank 0 on a free port, started first).
    Every rank must end within ``timeout_s`` of the start; one that does
    not is killed (its return code is then negative).  Returns (return
    code, stdout, stderr) for each rank.  Output goes through files, so a
    chatty rank never blocks on a full pipe."""
    port = free_port()
    base = dict(os.environ if env is None else env)
    procs, files = [], []
    try:
        for rank in range(world):
            out, err = tempfile.TemporaryFile(), tempfile.TemporaryFile()
            files.append((out, err))
            procs.append(subprocess.Popen(
                list(cmd), cwd=cwd, stdout=out, stderr=err,
                env=dict(base, RATTLE_COORDINATOR=f"127.0.0.1:{port}",
                         RATTLE_NUM_PROCESSES=str(world),
                         RATTLE_PROCESS_ID=str(rank))))
        deadline = time.monotonic() + timeout_s
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = []
    for p, (out, err) in zip(procs, files):
        texts = []
        for fh in (out, err):
            fh.seek(0)
            texts.append(fh.read().decode(errors="replace"))
            fh.close()
        res.append((p.returncode, *texts))
    return res


def main(argv=None) -> int:
    """``python -m rattle_tpu_torch.parallel.launch -n N [--timeout S] --
    MODE ARGS``: the port's CLI as N ranks on this host; prints each rank's
    standard error and exits non-zero if any rank failed."""
    ap = argparse.ArgumentParser(prog="rattle_tpu_torch.parallel.launch")
    ap.add_argument("-n", "--ranks", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=3600.0,
                    help="seconds every rank must end within")
    ap.add_argument("cli", nargs=argparse.REMAINDER,
                    help="-- MODE ARGS of rattle_tpu_torch.pipeline.cli")
    args = ap.parse_args(argv)
    cli = args.cli[1:] if args.cli[:1] == ["--"] else args.cli
    res = run_ranks([sys.executable, "-m", "rattle_tpu_torch.pipeline.cli",
                     *cli], args.ranks, args.timeout)
    for rank, (rc, out, err) in enumerate(res):
        print(f"--- rank {rank}: exit {rc}", file=sys.stderr)
        sys.stderr.write(err)
        if rank == 0:
            sys.stdout.write(out)
    return 0 if all(rc == 0 for rc, _o, _e in res) else 1


if __name__ == "__main__":
    sys.exit(main())
