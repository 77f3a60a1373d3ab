"""The port's CLI vs the JAX CLI (byte-identical outputs on the CPU), the
port's import boundary, and its explicit device selection."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rattle_tpu.pipeline import cli as jax_cli
from rattle_tpu_torch.device import resolve
from rattle_tpu_torch.pipeline import cli
from tests.conftest import make_read, mutate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def reads_fq(tmp_path_factory):
    """The 60-read input of tests/test_cli_e2e.py's bulk-engine parity test
    (above the engine's oracle cutover)."""
    rng = np.random.default_rng(31)
    refs = [make_read(rng, int(rng.integers(200, 300))) for _ in range(6)]
    path = tmp_path_factory.mktemp("cli") / "reads.fastq"
    with open(path, "w") as fh:
        i = 0
        for fam, ref in enumerate(refs):
            for _ in range(10):
                s = mutate(rng, ref, err=0.08)
                fh.write(f"@r{i}_f{fam}\n{s}\n+\n{'I' * len(s)}\n")
                i += 1
    return str(path)


@pytest.mark.parametrize("flags", [["--rna"], [], ["--rna", "--iso"]],
                         ids=["rna", "cdna", "iso"])
def test_cli_outputs_match_jax_cli(reads_fq, tmp_path, capsys, flags):
    out_t, out_j = tmp_path / "torch", tmp_path / "jax"
    out_t.mkdir()
    out_j.mkdir()
    base = ["cluster", "-i", reads_fq, "--raw", *flags]
    assert cli.main(base + ["-o", str(out_t), "--device", "cpu"]) == 0
    assert jax_cli.main(base + ["-o", str(out_j), "--mesh-devices", "1"]) == 0
    clusters = out_t / "clusters.out"
    assert clusters.read_bytes() == (out_j / "clusters.out").read_bytes()

    capsys.readouterr()
    summary = ["cluster_summary", "-i", reads_fq, "-c", str(clusters)]
    assert cli.main(summary) == 0
    got = capsys.readouterr().out
    assert jax_cli.main(summary) == 0
    assert got == capsys.readouterr().out
    assert len(got.splitlines()) == 60

    ext_t, ext_j = tmp_path / "ext_t", tmp_path / "ext_j"
    ext_t.mkdir()
    ext_j.mkdir()
    extract = ["extract_clusters", "-i", reads_fq, "-c", str(clusters),
               "--fastq"]
    assert cli.main(extract + ["-o", str(ext_t)]) == 0
    assert jax_cli.main(extract + ["-o", str(ext_j)]) == 0
    names = sorted(os.listdir(ext_t))
    assert names and names == sorted(os.listdir(ext_j))
    for name in names:
        assert (ext_t / name).read_bytes() == (ext_j / name).read_bytes()


def _forbidden(name: str) -> bool:
    return name == "jax" or name.startswith("jax.") or \
        name == "rattle_tpu" or name.startswith("rattle_tpu.")


def test_port_imports_neither_jax_nor_rattle_tpu():
    """A fresh interpreter (conftest has already imported jax here) imports
    every module of the port and chip_smoke.py; neither jax nor rattle_tpu
    may be loaded afterwards."""
    code = (
        "import importlib, pkgutil, sys, rattle_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(rattle_tpu_torch.__path__,\n"
        "                               'rattle_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "for m in ('correct.pack_engine', 'correct.runner', 'correct.polish',\n"
        "          'ops.poa', 'ops.poa_device', 'ops.similarity',\n"
        "          'ops.join_device', 'native'):\n"
        "    assert 'rattle_tpu_torch.' + m in sys.modules, m\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or\n"
        "             n.startswith(('jax.', 'rattle_tpu.')) or\n"
        "             n == 'rattle_tpu')\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_import_neither_jax_nor_rattle_tpu():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _dirs, files in os.walk(os.path.join(ROOT, "rattle_tpu_torch")):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    assert len(paths) > 20
    scanned = {os.path.relpath(p, ROOT) for p in paths}
    for mod in ("ops/poa.py", "ops/kernels.py", "correct/consensus.py",
                "correct/driver.py", "correct/polish.py",
                "correct/pack_engine.py", "correct/runner.py",
                "pipeline/cli.py", "ops/poa_device.py", "ops/similarity.py",
                "ops/join_device.py", "native.py"):
        assert os.path.join("rattle_tpu_torch", mod) in scanned
    for path in paths:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert not any(_forbidden(n) for n in names), (path, names)


def test_default_device_raises_without_a_card(monkeypatch, reads_fq,
                                              tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        resolve()
    with pytest.raises(RuntimeError, match="no CUDA"):
        cli.main(["cluster", "-i", reads_fq, "-o", str(tmp_path), "--rna"])
    assert not os.path.exists(tmp_path / "clusters.out")
    assert resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve("mps")
