"""The port's multi-process cluster path (parallel/launch.py on gloo, the
engine's mesh mode, ``--mesh-devices`` / ``--shard-input``) on the CPU,
against the JAX package's single-process engine, its CLI's ``--oracle`` and
the port's own single-process build.

Every multi-process case starts its ranks as subprocesses through
``launch.run_ranks``, which kills any rank still running at its deadline, so
a rank that dies can fail a case but never hang the run."""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from rattle_tpu.cluster import bulk as jbulk
from rattle_tpu.cluster import oracle
from rattle_tpu.config import ClusterParams as JaxParams
from rattle_tpu.ops import sketch_device as jsketch
from rattle_tpu.parallel import launch as jlaunch
from rattle_tpu.pipeline import cli as jax_cli
from rattle_tpu_torch.cluster.bulk import shard_plan
from rattle_tpu_torch.config import ClusterParams
from rattle_tpu_torch.ops.encode import reverse_complement_str
from rattle_tpu_torch.ops.sketch_device import (build_device_sketch,
                                                build_device_sketch_sharded,
                                                sketch_from_numpy)
from rattle_tpu_torch.parallel import launch
from rattle_tpu_torch.pipeline import cli
from tests.conftest import make_read, mutate

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 90

# one rank: a spec (JSON) names the CLI argv of each rank ("{rank}" is
# replaced by the rank), engine constants to set first, or an engine run
WORKER = r"""
import json, sys
import torch
torch.set_num_threads(1)
from rattle_tpu_torch.cluster import bulk
from rattle_tpu_torch.parallel import launch
from rattle_tpu_torch.utils import metrics
spec = json.loads(sys.argv[1])
for k, v in spec.get("consts", {}).items():
    setattr(bulk, k, v)
launch.init_distributed()
rank = launch.process_index()
out = dict(rank=rank)
if "engine" in spec:
    from rattle_tpu_torch.config import ClusterParams
    with open(spec["engine"]["seqs"]) as fh:
        seqs = json.load(fh)
    mesh = launch.data_mesh("cpu")
    eng = bulk.BulkClusterEngine(
        seqs, ClusterParams(is_rna=spec["engine"]["is_rna"]), mesh=mesh)
    out["sig"] = [(c.main_seq.seq_id, c.main_seq.rev,
                   [(s.seq_id, s.rev) for s in c.seqs])
                  for c in eng.cluster()]
    rc = 0
else:
    from rattle_tpu_torch.pipeline import cli
    argv = spec["argv"][min(rank, len(spec["argv"]) - 1)]
    rc = cli.main([a.replace("{rank}", str(rank)) for a in argv])
out.update(rc=rc, counters=metrics.GLOBAL.counters, stats=launch.STATS)
print(json.dumps(out))
sys.exit(rc)
"""


def _run(spec, world=2, timeout=RANK_TIMEOUT_S):
    """Run WORKER as ``world`` CPU ranks; returns [(rc, record or None,
    stderr)] by rank."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               RATTLE_TIMEOUT_S="60")
    for _attempt in range(3):
        res = launch.run_ranks([sys.executable, "-c", WORKER,
                                json.dumps(spec)], world, timeout, env=env,
                               cwd=ROOT)
        # the free port rank 0 was given can be taken by another process
        # before its store binds it: start the group again on a new one
        if not any("Address already in use" in err for _rc, _o, err in res):
            break
    out = []
    for rc, stdout, stderr in res:
        lines = stdout.strip().splitlines()
        rec = json.loads(lines[-1]) if rc == 0 and lines else None
        out.append((rc, rec, stderr))
    return out


def _ok(res):
    for rank, (rc, rec, err) in enumerate(res):
        assert rc == 0 and rec is not None, f"rank {rank} exit {rc}:\n{err}"
    return [rec for _rc, rec, _e in res]


def _families(seed, n_fam=6, per=16, lo=200, hi=380, err=0.08,
              revcomp=False):
    rng = np.random.default_rng(seed)
    seqs = []
    for _ in range(n_fam):
        ref = make_read(rng, int(rng.integers(lo, hi)))
        for _ in range(per):
            s = mutate(rng, ref, err)
            if revcomp and rng.random() < 0.5:
                s = reverse_complement_str(s)
            seqs.append(s)
    return seqs


def _sig(clusters):
    return [[c.main_seq.seq_id, c.main_seq.rev,
             [[s.seq_id, s.rev] for s in c.seqs]] for c in clusters]


# --------------------------------------------------------------------------
# shard bounds and plans
# --------------------------------------------------------------------------


@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
def test_process_shard_bounds_match_jax(world):
    for n in (0, 1, 7, 37, 256, 1001):
        bounds = [launch.process_shard_bounds(n, r, world)
                  for r in range(world)]
        assert bounds == [jlaunch.process_shard_bounds(n, r, world)
                          for r in range(world)]
        assert bounds[0][0] == 0 and bounds[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        sizes = [e - s for s, e in bounds]
        assert max(sizes) - min(sizes) <= 1
    assert launch.process_shard_bounds(10) == (0, 10)   # no process group


class _Mesh:
    """What JAX's shard_plan reads of a mesh."""

    def __init__(self, n_devices):
        self.devices = np.empty(n_devices, object)


@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
def test_shard_plan_follows_jax_rule(world, monkeypatch):
    """JAX's shard_plan for ``world`` processes of one device each (its
    process count and index patched) gives the same slices and padding;
    the slices partition [0, n)."""
    for n in (48, 96, 255, 256, 300, 1000, 8192):
        plans = [shard_plan(world, r, n) for r in range(world)]
        for rank, (start, end, n_pad) in enumerate(plans):
            monkeypatch.setattr(jax, "process_count", lambda: world)
            monkeypatch.setattr(jax, "process_index", lambda: rank)
            j_start, j_end, j_pad = jbulk.shard_plan(_Mesh(world), n)
            assert (start, n_pad) == (j_start, j_pad)
            assert end == max(j_start, j_end)
            assert n_pad % world == 0 and n_pad % 256 == 0
        cover = [i for s, e, _ in plans for i in range(s, e)]
        assert cover == list(range(n))


# --------------------------------------------------------------------------
# the sketch rows carried across ranks
# --------------------------------------------------------------------------


FIELDS = ("hbp", "hs", "ps", "bvp", "nk", "lens", "bvc")
REV_FIELDS = ("rev_hs", "rev_ps", "rev_bvp")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("both", [False, True], ids=["rna", "cdna"])
def test_sharded_sketch_builds_agree(world, both):
    """Each rank's rows (built with an explicit start and the global
    lengths, no process group), put together, equal the port's full build
    and JAX's build_device_sketch_sharded (one process over the 8 virtual
    CPU devices, carried over by sketch_from_numpy), row for row."""
    seqs = sorted(_families(21, n_fam=5, per=20, revcomp=both), key=len,
                  reverse=True)
    k = 10
    lens = np.array([len(s) for s in seqs])
    kmax = -(-(lens.max() - k) // 128) * 128
    assert np.all(lens - 6 <= kmax)   # clear of the JAX device sketch's tail
    full = build_device_sketch(seqs, k, both, device="cpu")
    parts = []
    for rank in range(world):
        start, end, n_pad = shard_plan(world, rank, len(seqs))
        parts.append(build_device_sketch_sharded(
            seqs[start:end], lens, start, n_pad // world, k, both,
            device="cpu"))
    jsk = jsketch.build_device_sketch_sharded(
        seqs, lens, 0, k, both, jlaunch.global_data_mesh(), n_pad)
    conv = sketch_from_numpy(
        *(np.asarray(getattr(jsk, f)) for f in
          ("hbp", "hs", "ps", "plane", "nk", "lens", "bvc")),
        **({"rev_hs": np.asarray(jsk.rev_hs), "rev_ps": np.asarray(jsk.rev_ps),
            "rev_plane": np.asarray(jsk.rev_plane)} if both else {}),
        kmer_size=k, device="cpu")
    assert full.kmax == conv.kmax == parts[0].kmax
    for f in FIELDS + (REV_FIELDS if both else ()):
        cat = torch.cat([getattr(p, f) for p in parts])
        assert torch.equal(cat, getattr(full, f)), f
        assert torch.equal(cat, getattr(conv, f)), f
    if not both:
        assert all(p.rev_hs is None for p in parts)


# --------------------------------------------------------------------------
# the engine over a 2-rank mesh
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [96, 192])
@pytest.mark.parametrize("is_rna", [True, False], ids=["rna", "cdna"])
def test_mesh_engine_two_ranks(is_rna, n, tmp_path):
    """BulkClusterEngine(mesh=) over two gloo ranks: both ranks return the
    clusters of JAX's single-process BulkClusterEngine and of the oracle.
    Rows go 128 a rank (256 padded rows), so at 96 reads rank 1 owns no
    read and still takes part in every collective; at 192 it owns 64."""
    seqs = sorted(_families(31 if is_rna else 32, per=n // 6,
                            revcomp=not is_rna, hi=250), key=len,
                  reverse=True)
    assert len(seqs) == n
    path = tmp_path / "seqs.json"
    path.write_text(json.dumps(seqs))
    recs = _ok(_run({"engine": {"seqs": str(path), "is_rna": is_rna}}))
    want = _sig(oracle.cluster_reads(seqs, ClusterParams(is_rna=is_rna)))
    jax_got = _sig(jbulk.BulkClusterEngine(seqs,
                                           JaxParams(is_rna=is_rna)).cluster())
    assert jax_got == want
    for rec in recs:
        assert rec["sig"] == want
        assert rec["stats"]["calls"] > 0


# --------------------------------------------------------------------------
# the CLI over two ranks
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    """{"rna", "cdna"}: 192 reads of 6 families, 200-380 bp, in file order
    (the cDNA file has half its reads reverse-complemented).  Rank 0 owns
    the 128 longest, rank 1 the other 64."""
    d = tmp_path_factory.mktemp("dist")
    out = {}
    for label, rc in (("rna", False), ("cdna", True)):
        path = d / f"{label}.fq"
        with open(path, "w") as fh:
            for i, s in enumerate(_families(41, per=32, revcomp=rc)):
                fh.write(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n")
        out[label] = str(path)
    return out


def _oracle_out(fq, flags, tmp_path) -> bytes:
    d = tmp_path / "jax_oracle"
    d.mkdir()
    assert jax_cli.main(["cluster", "-i", fq, "-o", str(d), "--oracle",
                         *flags]) == 0
    return (d / "clusters.out").read_bytes()


def _cluster_two_ranks(fq, flags, tmp_path, **spec):
    """``cluster`` on two CPU ranks, each writing into out{rank}; returns
    the ranks' records."""
    for r in (0, 1):
        (tmp_path / f"out{r}").mkdir()
    argv = ["cluster", "-i", fq, "-o", str(tmp_path / "out{rank}"),
            "--device", "cpu", *flags]
    return _ok(_run(dict(spec, argv=[argv])))


CLI_CASES = {
    "rna_mesh": ("rna", ["--rna"]),
    "rna_shard": ("rna", ["--rna", "--shard-input"]),
    "cdna_mesh": ("cdna", []),
    "cdna_shard": ("cdna", ["--shard-input"]),
    "iso_mesh": ("rna", ["--rna", "--iso"]),
    "rna_mesh_devices_1": ("rna", ["--rna", "--mesh-devices", "1"]),
    "rna_checkpoint": ("rna", ["--rna", "--checkpoint-dir", "{ck}"]),
    "rna_oracle": ("rna", ["--rna", "--oracle"]),
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_two_ranks_match_jax_oracle(case, fastq, tmp_path):
    """Rank 0's clusters.out is byte for byte the JAX CLI's ``--oracle``;
    rank 1 writes nothing.  On the mesh every rank exchanges data; with
    ``--mesh-devices 1`` (or ``--oracle``) each rank runs the whole engine
    and none does."""
    label, flags = CLI_CASES[case]
    ck = tmp_path / "ck"
    flags = [f.replace("{ck}", str(ck)) for f in flags]
    recs = _cluster_two_ranks(fastq[label], flags, tmp_path)
    want = _oracle_out(fastq[label], [f for f in flags if f == "--rna"
                                      or f == "--iso"], tmp_path)
    assert (tmp_path / "out0" / "clusters.out").read_bytes() == want
    assert os.listdir(tmp_path / "out1") == []
    calls = [r["stats"]["calls"] for r in recs]
    if "--mesh-devices" in flags or "--oracle" in flags:
        assert calls == [0, 0]
    else:
        assert all(c > 0 for c in calls)
    assert not ck.exists()   # rank 0 finalized the manifest


def test_cli_shard_input_forced_rescore_fetches_remote_reads(fastq,
                                                             tmp_path):
    """Every score-passing pair made borderline (the engine constant that
    chip_smoke.py's phase 7 sets) under ``--shard-input``: the host rescores
    need reads that the other rank owns, and the output is the oracle's."""
    recs = _cluster_two_ranks(fastq["rna"], ["--rna", "--shard-input"],
                              tmp_path, consts={"VAR_BAND_REL": 1e12})
    assert all(r["counters"]["cluster.host_rescores"] > 0 for r in recs)
    assert sum(r["counters"]["cluster.remote_reads"] for r in recs) > 0
    want = _oracle_out(fastq["rna"], ["--rna"], tmp_path)
    assert (tmp_path / "out0" / "clusters.out").read_bytes() == want
    assert os.listdir(tmp_path / "out1") == []


def test_cli_rank_failing_before_first_collective(fastq, tmp_path):
    """Rank 1 cannot read its input and raises before the engine's first
    collective: rank 0 fails too, well inside the deadline, and writes
    nothing."""
    out = tmp_path / "out"
    out.mkdir()
    base = ["cluster", "-o", str(out), "--device", "cpu", "--rna"]
    res = _run({"argv": [base + ["-i", fastq["rna"]],
                         base + ["-i", str(tmp_path / "missing.fq")]]},
               timeout=75)
    (rc0, _rec0, err0), (rc1, _rec1, err1) = res
    assert rc1 != 0 and "missing.fq" in err1
    assert rc0 > 0, err0       # an error exit, not killed at the deadline
    assert os.listdir(out) == []


def test_cli_two_ranks_cuda_without_a_card(fastq, tmp_path):
    """The default --device cuda raises on every rank without a card:
    nothing carries on on the CPU."""
    res = _run({"argv": [["cluster", "-i", fastq["rna"], "-o",
                          str(tmp_path), "--rna"]]})
    for rc, _rec, err in res:
        assert rc != 0 and "no CUDA" in err
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("argv,msg", [
    (["--mesh-devices", "2"], "--mesh-devices 2 is neither 0, 1 nor the "
     "world size 1"),
    (["--shard-input", "--iso"], "incompatible"),
    (["--shard-input", "--oracle"], "incompatible"),
    (["--shard-input", "--checkpoint-dir", "ck"], "incompatible"),
], ids=["mesh_devices", "iso", "oracle", "checkpoint"])
def test_cli_rejects_bad_mesh_options(argv, msg, fastq, tmp_path, capsys):
    assert cli.main(["cluster", "-i", fastq["rna"], "-o", str(tmp_path),
                     "--device", "cpu", "--rna", *argv]) == 1
    assert msg in capsys.readouterr().err
    assert os.listdir(tmp_path) == []


def test_cli_mesh_devices_error_names_both_numbers(fastq, tmp_path):
    """--mesh-devices 3 in a world of 2 fails on both ranks."""
    res = _run({"argv": [["cluster", "-i", fastq["rna"], "-o",
                          str(tmp_path), "--device", "cpu", "--rna",
                          "--mesh-devices", "3"]]})
    for rc, _rec, err in res:
        assert rc == 1 and "--mesh-devices 3" in err and "size 2" in err


def test_cli_shard_input_single_process_matches(fastq, tmp_path):
    """``--shard-input`` without a process group: one rank holds every
    read, and the output is the unsharded CLI's."""
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    base = ["cluster", "-i", fastq["cdna"], "--device", "cpu"]
    assert cli.main(base + ["-o", str(a), "--shard-input"]) == 0
    assert cli.main(base + ["-o", str(b)]) == 0
    assert (a / "clusters.out").read_bytes() == \
        (b / "clusters.out").read_bytes()


def test_new_modules_are_under_the_import_scan():
    """parallel/launch.py and cluster/host_engine.py lie under the tree that
    tests/test_torch_cli.py scans, and import neither jax nor rattle_tpu."""
    import ast
    from tests.test_torch_cli import _forbidden
    for mod in ("parallel/__init__.py", "parallel/launch.py",
                "cluster/host_engine.py", "cluster/bulk.py",
                "pipeline/stages.py"):
        path = os.path.join(ROOT, "rattle_tpu_torch", mod)
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert not any(_forbidden(n) for n in names), (mod, names)
