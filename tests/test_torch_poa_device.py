"""The port's lockstep POA path on the CPU: ``poa_align_batch`` (the plain
version of csrc/poa_align_batch.cu) vs rattle_tpu/ops/poa_device.py, the
lockstep and native backends of ``correct/runner.batched_msa`` vs
rattle_tpu/correct/tpu_runner.py and the oracle ``ops/poa.py::poa_msa``,
and ``correct`` through the port's CLI with RATTLE_POA_BACKEND=lockstep vs
``--poa-backend host``.

All integers: tolerance 0.  ``packed`` is compared over ``length`` (the
rest is undefined on the card).  Both packages' ``native.available`` are
pinned to False where the two runners are compared: the JAX package loads
the library committed in native/, which is older than its source.
"""

import gc
import os
import weakref

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rattle_tpu import native as jax_native
from rattle_tpu.correct import tpu_runner as jax_runner
from rattle_tpu.ops import poa as jax_poa
from rattle_tpu.ops import poa_device as jax_pd
from rattle_tpu_torch import native as port_native
from rattle_tpu_torch.config import CorrectParams
from rattle_tpu_torch.correct import runner
from rattle_tpu_torch.correct.pack_engine import PackEngine
from rattle_tpu_torch.io import fastx
from rattle_tpu_torch.ops import kernels
from rattle_tpu_torch.ops import poa as port_poa
from rattle_tpu_torch.ops import poa_device
from rattle_tpu_torch.pipeline import cli
from tests.conftest import make_read, mutate

# The suite runs in several worker processes; with torch's default intra-op
# pool in each, the small CPU ops of the plain kernel versions oversubscribe
# the cores and run many times slower.
torch.set_num_threads(1)

PMAX = 8
CORRECT_FILES = ("corrected.fq", "uncorrected.fq", "consensi.fq")


def _rank_arrays(g, n_cap):
    """(letters [n_cap] u8, preds [n_cap, 8] i32, rank_nodes) of a graph of
    ops/poa.py in topological-rank order (the runner's Python path)."""
    _, order = g.topo_groups()
    rank_nodes = [nid for members in order for nid in members]
    rank_of = {nid: r for r, nid in enumerate(rank_nodes)}
    letters = np.zeros(n_cap, np.uint8)
    preds = np.full((n_cap, PMAX), -1, np.int32)
    for r, nid in enumerate(rank_nodes):
        letters[r] = ord(g.letters[nid])
        ins = g.in_edges[nid]
        if not ins:
            preds[r, 0] = 0
        for k, a in enumerate(ins):
            preds[r, k] = rank_of[a] + 1
    return letters, preds, rank_nodes


def _grow(reads):
    g = jax_poa.POAGraph()
    p = jax_poa.POAParams()
    for s in reads:
        jax_poa.add_alignment(g, jax_poa.align_local(g, s, p), s)
    return g


def _lanes(l_cap):
    """(name, graph, read) per lane, from one numpy seed: the incremental
    graphs of an 8-read pack at 12% error (the empty graph first), a larger
    graph beside them, an unrelated read, and a lane with no graph and no
    read."""
    rng = np.random.default_rng(2025 + l_cap)
    ref = make_read(rng, 90)
    reads = [mutate(rng, ref, 0.12) for _ in range(8)]
    lanes = [(f"incremental_{t}", _grow(reads[:t]), reads[t])
             for t in range(8)]
    big = make_read(rng, 118)
    lanes.append(("larger_graph", _grow([mutate(rng, big, 0.1)
                                          for _ in range(6)]),
                  mutate(rng, big, 0.1)))
    lanes.append(("unrelated", _grow(reads[:3]), make_read(rng, 80)))
    lanes.append(("no_graph_no_read", jax_poa.POAGraph(), ""))
    if l_cap > 128:
        # a read far longer than its graph, on the int32 path
        lanes.append(("long_read", _grow(reads[:2]),
                      ref[:60] + make_read(rng, 2500) + ref[60:]))
    else:
        lanes.append(("identical", _grow(reads[:4]), reads[2]))
    return lanes


def _batch(lanes, n_cap, l_cap, pred_dtype):
    b = len(lanes)
    letters = np.zeros((b, n_cap), np.uint8)
    preds = np.full((b, n_cap, PMAX), -1, pred_dtype)
    n_nodes = np.zeros(b, np.int32)
    seq = np.zeros((b, l_cap), np.uint8)
    seq_len = np.zeros(b, np.int32)
    ranks = []
    for li, (_name, g, read) in enumerate(lanes):
        let, pr, rank_nodes = _rank_arrays(g, n_cap)
        letters[li], preds[li], n_nodes[li] = let, pr, len(rank_nodes)
        raw = np.frombuffer(read.encode("ascii"), np.uint8)
        seq[li, :len(raw)] = raw
        seq_len[li] = len(raw)
        ranks.append(rank_nodes)
    return (letters, preds, n_nodes, seq, seq_len), ranks


LANES = 12
# (l_cap, n_cap): the int16 path at 128, the int32 path at 4096
SHAPES = {"int16": (128, 256), "int32": (4096, 256)}


@pytest.fixture(scope="module", params=[
    ("int16", np.int16), ("int16", np.int32), ("int32", np.int32)],
    ids=["L128_preds16", "L128_preds32", "L4096_preds32"])
def aligned_batch(request):
    path, pred_dtype = request.param
    l_cap, n_cap = SHAPES[path]
    lanes = _lanes(l_cap)
    ins, ranks = _batch(lanes, n_cap, l_cap, pred_dtype)
    want = jax_pd.poa_align_batch(*[jnp.asarray(x) for x in ins])
    want = jax_pd.BatchedAlignment(*[np.asarray(x) for x in want])
    before = kernels.poa_align_batch.launches
    got = poa_device.poa_align_batch(*[torch.from_numpy(x) for x in ins])
    assert kernels.poa_align_batch.launches == before   # the CPU: no launch
    return lanes, ins, ranks, want, got


@pytest.mark.parametrize("lane", range(LANES))
def test_poa_align_batch_matches_jax(aligned_batch, lane):
    lanes, _ins, _ranks, want, got = aligned_batch
    assert got.packed.shape == want.packed.shape
    assert got.packed.dtype == torch.int32 and got.aligned.dtype == torch.bool
    ln = int(want.length[lane])
    assert int(got.length[lane]) == ln
    assert bool(got.aligned[lane]) == bool(want.aligned[lane])
    np.testing.assert_array_equal(got.packed[lane, :ln].numpy(),
                                  want.packed[lane, :ln])


def test_poa_align_batch_lanes_cover_the_cases(aligned_batch):
    lanes, ins, _ranks, want, _got = aligned_batch
    names = [name for name, *_ in lanes]
    n_nodes, seq_len = ins[2], ins[4]
    assert n_nodes[names.index("incremental_0")] == 0
    assert want.length[names.index("no_graph_no_read")] == 0
    assert not want.aligned[names.index("incremental_0")]
    # mixed sizes, several predecessors
    assert len(lanes) == LANES and len(set(n_nodes.tolist())) >= 8
    assert (ins[1][:, :, 1] >= 0).any()
    assert (seq_len > 0).sum() == LANES - 1


@pytest.mark.parametrize("lane", range(LANES))
def test_alignment_to_host_matches_jax_and_oracle(aligned_batch, lane):
    lanes, _ins, ranks, want, got = aligned_batch
    _name, g, read = lanes[lane]
    aln = poa_device.alignment_to_host(got, lane, ranks[lane], len(read))
    assert aln == jax_pd.alignment_to_host(want, lane, ranks[lane], len(read))
    want_oracle = jax_poa.align_local(g, read, jax_poa.POAParams()) \
        if g.n_nodes() else []
    assert aln == want_oracle


def test_poa_align_batch_rejects_bad_inputs():
    ins = [torch.from_numpy(x) for x in _batch(_lanes(128)[:2], 128, 128,
                                               np.int32)[0]]
    with pytest.raises(ValueError, match="int16 or int32"):
        kernels.poa_align_batch(ins[0], ins[1].to(torch.int64), *ins[2:])
    with pytest.raises(ValueError, match="P <= 8"):
        kernels.poa_align_batch(ins[0], torch.cat([ins[1], ins[1]], 2),
                                *ins[2:])
    with pytest.raises(ValueError, match="share"):
        kernels.poa_align_batch(ins[0], ins[1][:1], *ins[2:])
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.poa_align_batch(*[x.to("meta") for x in ins])


# --------------------------------------------------------------------------
# the lockstep and native runners
# --------------------------------------------------------------------------


def _packs():
    """Noisy packs of several sizes, a pack whose graph outgrows its group's
    n_cap (512 nodes: homopolymers of six letters align nowhere) and a pack
    with a node of ten predecessors (ten prefixes of their own before one
    A run); both finish on the host aligner."""
    rng = np.random.default_rng(99)
    packs = []
    for size, length in ((5, 70), (7, 95), (4, 60), (8, 110), (6, 85)):
        ref = make_read(rng, length)
        packs.append(sorted((mutate(rng, ref, 0.1) for _ in range(size)),
                            key=len, reverse=True))
    packs.append([c * 110 for c in "ACGTNR"])
    packs.append([c * 20 + "A" * 40 for c in "CGTNRYKMSW"])
    return packs


def _pin_native(monkeypatch, available: bool):
    monkeypatch.setattr(jax_native, "available", lambda: available)
    monkeypatch.setattr(port_native, "available", lambda: available)


@pytest.fixture(scope="module")
def lockstep_runs():
    """Both packages' batched_msa with RATTLE_POA_BACKEND=lockstep, the
    Python graphs on both sides; the rows and the LAST_STATS deltas."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("RATTLE_POA_BACKEND", "lockstep")
        _pin_native(mp, False)
        packs = _packs()
        j0, t0 = dict(jax_runner.LAST_STATS), dict(runner.LAST_STATS)
        want = jax_runner.batched_msa(packs, jax_poa.POAParams())
        eng = PackEngine(device="cpu")
        lock = runner.LockstepRunner(device="cpu")
        got = runner.batched_msa(packs, port_poa.POAParams(), eng, lock)
        dj = {k: jax_runner.LAST_STATS[k] - j0[k] for k in j0}
        dt = {k: runner.LAST_STATS[k] - t0[k] for k in t0}
    finally:
        mp.undo()
    return packs, want, got, dj, dt, eng, lock


@pytest.mark.parametrize("i", range(7))
def test_lockstep_rows_equal_jax_and_oracle(lockstep_runs, i):
    packs, want, got, *_ = lockstep_runs
    assert got[i] == want[i]
    assert got[i] == jax_poa.poa_msa(packs[i], jax_poa.POAParams())


def test_lockstep_stats_equal_jax(lockstep_runs):
    _packs, _w, _g, dj, dt, eng, lock = lockstep_runs
    assert {k: dt[k] for k in dj} == dj
    assert dj["fallback_packs"] == 2 and dj["device_packs"] == 5
    assert dj["host_bases"] > 0
    # the pack engine ran nothing; the runner counted its read steps
    assert eng.stats["device_packs"] == eng.stats["fallback_packs"] == 0
    assert 0 < lock.stats["steps"] == dt["steps"] <= 10
    assert lock.stats["device_packs"] == 5


def test_lockstep_with_the_native_library_matches_oracle(monkeypatch):
    """The port's own library (built from the source) behind the lanes."""
    monkeypatch.setenv("RATTLE_POA_BACKEND", "lockstep")
    assert port_native.available()
    packs = _packs()[:3]
    got = runner.batched_msa(packs, port_poa.POAParams(),
                             PackEngine(device="cpu"))
    assert got == [jax_poa.poa_msa(p, jax_poa.POAParams()) for p in packs]


@pytest.mark.parametrize("available", [False, True],
                         ids=["python_graph", "native_graph"])
def test_native_backend_matches_jax_and_oracle(monkeypatch, available):
    monkeypatch.setenv("RATTLE_POA_BACKEND", "native")
    packs = _packs()
    monkeypatch.setattr(port_native, "available", lambda: available)
    monkeypatch.setattr(jax_native, "available", lambda: False)
    native = {"packs": 0, "bases": 0}
    t0 = dict(runner.LAST_STATS)
    got = runner.batched_msa(packs, port_poa.POAParams(),
                             PackEngine(device="cpu"), native=native)
    assert got == jax_runner.batched_msa(packs, jax_poa.POAParams())
    assert got == [jax_poa.poa_msa(p, jax_poa.POAParams()) for p in packs]
    assert dict(runner.LAST_STATS) == t0       # as in JAX: not counted
    assert native["packs"] == len(packs)
    assert native["bases"] == sum(len(s) for p in packs for s in p)


def test_pack_runner_makes_a_lockstep_runner_only_when_chosen(monkeypatch):
    """make_pack_runner builds its LockstepRunner when
    RATTLE_POA_BACKEND=lockstep first chooses it, counts the native
    backend's packs on its own, and the pack engine runs neither."""
    packs = _packs()[:3]
    want = [jax_poa.poa_msa(p, jax_poa.POAParams()) for p in packs]
    pr = runner.make_pack_runner("cpu")
    monkeypatch.setenv("RATTLE_POA_BACKEND", "native")
    assert pr.batch_msa(packs, CorrectParams()) == want
    assert pr.lockstep is None
    assert pr.native == {"packs": 3,
                         "bases": sum(len(s) for p in packs for s in p)}
    monkeypatch.setenv("RATTLE_POA_BACKEND", "lockstep")
    assert pr.batch_msa(packs, CorrectParams()) == want
    made = pr.lockstep
    assert made.stats["device_packs"] == 3 and made.stats["steps"] > 0
    assert pr.batch_msa(packs, CorrectParams()) == want
    assert pr.lockstep is made and made.stats["device_packs"] == 6
    assert pr.native["packs"] == 3
    assert pr.engine.stats["device_packs"] == 0
    # no reference cycle: the engine and the lockstep runner (and so their
    # device scratch) go as soon as the runner does, with no cyclic GC
    refs = [weakref.ref(pr.engine), weakref.ref(made)]
    gc.disable()
    try:
        del pr, made
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()


# --------------------------------------------------------------------------
# correct through the CLI
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def clustered(tmp_path_factory):
    """48 reads of 6 families (70-120 bp) and their oracle clusters."""
    rng = np.random.default_rng(48)
    root = tmp_path_factory.mktemp("lockstep")
    fq = root / "reads.fastq"
    with open(fq, "w") as fh:
        i = 0
        for fam in range(6):
            ref = make_read(rng, int(rng.integers(70, 120)))
            for _ in range(8):
                s = mutate(rng, ref, err=0.08)
                fh.write(f"@r{i}_f{fam}\n{s}\n+\n{'I' * len(s)}\n")
                i += 1
    assert cli.main(["cluster", "-i", str(fq), "-o", str(root), "--rna",
                     "--raw", "--oracle"]) == 0
    clusters = str(root / "clusters.out")
    host = root / "host"
    host.mkdir()
    assert cli.main(["correct", "-i", str(fq), "-c", clusters, "-o",
                     str(host), "--poa-backend", "host"]) == 0
    return str(fq), clusters, host


@pytest.mark.parametrize("backend", ["lockstep", "native"])
def test_correct_cli_backend_matches_host(clustered, tmp_path, monkeypatch,
                                          capsys, backend):
    fq, clusters, host = clustered
    assert len(fastx.read_fastq_plain(fq)) >= 48
    monkeypatch.setenv("RATTLE_POA_BACKEND", backend)
    assert cli.main(["correct", "-i", fq, "-c", clusters, "-o",
                     str(tmp_path), "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert f"POA packs ({backend}):" in err
    assert "POA packs: " not in err           # the pack engine ran nothing
    for name in CORRECT_FILES:
        got = (tmp_path / name).read_bytes()
        assert got == (host / name).read_bytes(), name
    assert (tmp_path / "consensi.fq").read_bytes()
    assert os.environ["RATTLE_POA_BACKEND"] == backend
