"""The second slice as a whole on the CPU: the port's ``correct`` and
``polish`` through its CLI vs the JAX CLI on the 30-read fastq of
tests/test_cli_e2e.py (byte-identical files), checkpoint resume, and the
port's bulk cluster engine under polish's hard-coded parameters.
"""

import json
import os

import numpy as np
import pytest
import torch

from rattle_tpu.cluster import oracle
from rattle_tpu.ops.encode import reverse_complement_str
from rattle_tpu.pipeline import cli as jax_cli
from rattle_tpu_torch.cluster.bulk import ORACLE_CUTOVER, cluster_reads_bulk
from rattle_tpu_torch.config import (POLISH_CLUSTER_PARAMS, CorrectParams,
                                     replace)
from rattle_tpu_torch.correct import driver
from rattle_tpu_torch.correct.runner import make_pack_runner
from rattle_tpu_torch.io import fastx, hpsio
from rattle_tpu_torch.pipeline import cli
from rattle_tpu_torch.utils import checkpoint
from tests.conftest import make_read, mutate

# The suite runs in several worker processes; with torch's default intra-op
# pool in each, the small CPU ops of the plain kernel versions oversubscribe
# the cores and run many times slower.
torch.set_num_threads(1)

CORRECT_FILES = ("corrected.fq", "uncorrected.fq", "consensi.fq")


@pytest.fixture(scope="module")
def clustered(tmp_path_factory):
    """The 30-read input of tests/test_cli_e2e.py and its clusters.out."""
    rng = np.random.default_rng(77)
    refs = [make_read(rng, int(rng.integers(220, 320))) for _ in range(3)]
    root = tmp_path_factory.mktemp("correct")
    fq = root / "reads.fastq"
    with open(fq, "w") as fh:
        i = 0
        for fam, ref in enumerate(refs):
            for _ in range(10):
                s = mutate(rng, ref, err=0.08)
                fh.write(f"@read{i}_fam{fam}\n{s}\n+\n{'I' * len(s)}\n")
                i += 1
    assert jax_cli.main(["cluster", "-i", str(fq), "-o", str(root), "--rna",
                         "--raw", "--oracle"]) == 0
    return str(fq), str(root / "clusters.out"), root


@pytest.fixture(scope="module")
def corrected(clustered):
    """``correct`` through both CLIs: the port on the CPU, the JAX package
    on its device pack runner (Pallas kernel in interpret mode)."""
    fq, clusters, root = clustered
    out_t, out_j = root / "torch", root / "jax"
    out_t.mkdir()
    out_j.mkdir()
    base = ["correct", "-i", fq, "-c", clusters]
    assert cli.main(base + ["-o", str(out_t), "--device", "cpu"]) == 0
    assert jax_cli.main(base + ["-o", str(out_j), "--poa-backend",
                                "tpu"]) == 0
    return out_t, out_j


@pytest.mark.parametrize("name", CORRECT_FILES)
def test_correct_matches_jax_cli(corrected, name):
    out_t, out_j = corrected
    got = (out_t / name).read_bytes()
    assert got == (out_j / name).read_bytes()
    if name != "uncorrected.fq":
        assert got


def test_correct_accounts_every_read(corrected):
    out_t, _ = corrected
    n = sum(len(fastx.read_fastq_plain(str(out_t / name)))
            for name in ("corrected.fq", "uncorrected.fq"))
    assert n == 30
    assert len(fastx.read_fastq_plain(str(out_t / "consensi.fq"))) == 3


def test_correct_host_backend_matches_device_backend(clustered, corrected,
                                                     tmp_path):
    """``--poa-backend host`` (the Python POA oracle; it needs no device)
    writes the same files as the pack engine."""
    fq, clusters, _root = clustered
    assert cli.main(["correct", "-i", fq, "-c", clusters, "-o", str(tmp_path),
                     "--poa-backend", "host"]) == 0
    for name in CORRECT_FILES:
        assert (tmp_path / name).read_bytes() == \
            (corrected[0] / name).read_bytes()


@pytest.fixture(scope="module")
def polished(corrected):
    """``polish --rna --summary`` through both CLIs on their consensi."""
    for out, main, extra in zip(corrected, (cli.main, jax_cli.main),
                                (["--device", "cpu"],
                                 ["--poa-backend", "tpu"])):
        assert main(["polish", "-i", str(out / "consensi.fq"), "-o",
                     str(out), "--rna", "--summary", *extra]) == 0
    return corrected


@pytest.mark.parametrize("name", ("transcriptome.fq", "polish_summary.tsv"))
def test_polish_matches_jax_cli(polished, name):
    out_t, out_j = polished
    got = (out_t / name).read_bytes()
    assert got and got == (out_j / name).read_bytes()


def test_correct_resume_is_byte_identical(clustered, tmp_path, monkeypatch):
    """A ``correct --checkpoint-dir`` run that dies after three packs and is
    run again writes the files of an uninterrupted run."""
    fq, clusters_path, _root = clustered
    flags = ["-s", "4", "-r", "2", "--device", "cpu"]
    golden = tmp_path / "golden"
    resumed = tmp_path / "resumed"
    golden.mkdir()
    resumed.mkdir()
    base = ["correct", "-i", fq, "-c", clusters_path]
    assert cli.main(base + ["-o", str(golden), *flags]) == 0

    # every finished pack reaches the manifest at once
    monkeypatch.setattr(checkpoint.CorrectCheckpoint, "FLUSH_EVERY", 1)
    ckdir = str(tmp_path / "ck")
    inner = make_pack_runner("cpu")

    def dying_runner(packs, p, msa_fn):
        outcomes = inner(packs, p, msa_fn)

        def some():
            for k, out in enumerate(outcomes):
                if k >= 3:
                    raise KeyboardInterrupt
                yield out
        return some()

    reads = fastx.read_multiple_inputs([fq], [])
    clusters = hpsio.read_clusters(clusters_path)
    with pytest.raises(KeyboardInterrupt):
        driver.correct_reads(
            clusters, reads, CorrectParams(min_occ=0.3, gap_occ=0.3, split=4,
                                           min_reads=2),
            labels=[], pack_runner=dying_runner, checkpoint_dir=ckdir)
    with open(os.path.join(ckdir, "manifest.json")) as fh:
        assert json.load(fh)["finished"] == [0, 1, 2]

    seen = []
    real = make_pack_runner

    def counting(device="cuda"):
        runner = real(device)

        def wrapped(packs, p, msa_fn):
            seen.append(len(packs))
            return runner(packs, p, msa_fn)
        wrapped.batch_msa = runner.batch_msa
        wrapped.engine = runner.engine
        wrapped.lockstep = runner.lockstep
        wrapped.native = runner.native
        return wrapped

    monkeypatch.setattr("rattle_tpu_torch.correct.runner.make_pack_runner",
                        counting)
    assert cli.main(base + ["-o", str(resumed), *flags, "--checkpoint-dir",
                            ckdir]) == 0
    n_packs = len(driver.build_packs(
        hpsio.read_clusters(clusters_path),
        fastx.read_multiple_inputs([fq], []), 4, 2)[0])
    assert seen == [n_packs - 3]          # only the remainder was recomputed
    assert not os.path.exists(ckdir)      # finalize removed the checkpoint
    for name in CORRECT_FILES:
        assert (resumed / name).read_bytes() == (golden / name).read_bytes()


def test_correct_default_device_raises_without_a_card(clustered, tmp_path,
                                                      monkeypatch):
    fq, clusters, _root = clustered
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        cli.main(["correct", "-i", fq, "-c", clusters, "-o", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA"):
        cli.main(["polish", "-i", fq, "-o", str(tmp_path), "--rna"])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("flags", [[], ["--rna", "--iso"]],
                         ids=["cdna", "iso"])
def test_correct_on_cdna_and_iso_clusters(tmp_path, flags):
    """Clusters with reverse-complemented members (cDNA) and with
    transcript/gene ids (--iso): the port's pack engine, its host backend
    and the JAX CLI's host backend write the same files."""
    rng = np.random.default_rng(78)
    refs = [make_read(rng, int(rng.integers(150, 220))) for _ in range(2)]
    fq = tmp_path / "reads.fastq"
    with open(fq, "w") as fh:
        i = 0
        for fam, ref in enumerate(refs):
            for _ in range(8):
                s = mutate(rng, ref, err=0.08)
                if not flags and rng.random() < 0.5:
                    s = reverse_complement_str(s)
                fh.write(f"@read{i}_fam{fam}\n{s}\n+\n{'I' * len(s)}\n")
                i += 1
    assert jax_cli.main(["cluster", "-i", str(fq), "-o", str(tmp_path),
                         "--raw", "--oracle", *flags]) == 0
    clusters = hpsio.read_clusters(str(tmp_path / "clusters.out"))
    if flags:
        assert all(c.main_seq.gene_id != -1 for c in clusters)
    else:
        assert any(s.rev for c in clusters for s in c.seqs)
    outs = {}
    for name, main, extra in (("device", cli.main, ["--device", "cpu"]),
                              ("host", cli.main, ["--poa-backend", "host"]),
                              ("jax", jax_cli.main,
                               ["--poa-backend", "host"])):
        outs[name] = tmp_path / name
        outs[name].mkdir()
        assert main(["correct", "-i", str(fq), "-c",
                     str(tmp_path / "clusters.out"), "-o", str(outs[name]),
                     *extra]) == 0
    for name in CORRECT_FILES:
        want = (outs["jax"] / name).read_bytes()
        assert (outs["host"] / name).read_bytes() == want
        assert (outs["device"] / name).read_bytes() == want
    assert (outs["jax"] / "consensi.fq").read_bytes()


def _consensus_like(seed, n_transcripts, copies):
    """Near-identical copies of a few transcripts, length-sorted as polish
    sorts its consensi."""
    rng = np.random.default_rng(seed)
    seqs = []
    for _ in range(n_transcripts):
        ref = make_read(rng, int(rng.integers(200, 420)))
        seqs += [mutate(rng, ref, err=0.03) for _ in range(copies)]
    seqs.sort(key=lambda s: -len(s))
    return seqs


@pytest.mark.parametrize("is_rna", (True, False), ids=("rna", "cdna"))
def test_bulk_engine_under_polish_params_matches_oracle(is_rna):
    """polish re-clusters with k = 6, t_s 0.5, t_v 25, B = b = 0.4; above
    the oracle cutover the port's device engine must agree with the oracle."""
    seqs = _consensus_like(91 + is_rna, n_transcripts=18, copies=3)
    assert len(seqs) >= ORACLE_CUTOVER
    params = replace(POLISH_CLUSTER_PARAMS, is_rna=is_rna)

    def sig(clusters):
        return [(c.main_seq.seq_id, c.main_seq.rev,
                 [(s.seq_id, s.rev) for s in c.seqs]) for c in clusters]

    want = sig(oracle.cluster_reads(seqs, params))
    got = sig(cluster_reads_bulk(seqs, params, device="cpu"))
    assert got == want
    assert 10 <= len(want) < len(seqs)
