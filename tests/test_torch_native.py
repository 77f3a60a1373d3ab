"""The port's native library: built from native/rattle_native.cpp into
build/rattle_tpu_torch/ (never the library committed beside the source), and
its POA graph equal to the JAX package's Python POA (rattle_tpu/ops/poa.py)
on 200 seeded 7-read packs: alignments, MSA and node count."""

import os

import numpy as np
import pytest

from rattle_tpu.ops import poa
from rattle_tpu_torch import _ext, native
from tests.conftest import make_read, mutate

PACKS = 200
SEEDS = 4


@pytest.fixture(scope="module")
def lib():
    lib = native._load()
    if lib is None:
        pytest.fail("the native library did not build (no C++ compiler?)")
    return lib


def test_library_is_built_under_build_dir(lib):
    assert os.path.dirname(lib._name) == _ext.BUILD_DIR
    assert lib._name == native.SO
    with open(native.SO + ".sha256") as fh:
        assert fh.read().strip() == native._source_hash()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.realpath(lib._name) != os.path.realpath(
        os.path.join(root, "native", "librattle_native.so"))


@pytest.mark.parametrize("seed", range(SEEDS))
def test_native_poa_matches_python(lib, seed):
    params = poa.POAParams()
    rng = np.random.default_rng(seed)
    for _ in range(PACKS // SEEDS):
        ref = make_read(rng, 80)
        reads = [mutate(rng, ref, err=0.12) for _ in range(7)]
        g_py = poa.POAGraph()
        g_nat = native.NativePoaGraph()
        for s in reads:
            a_py = poa.align_local(g_py, s, params)
            a_nat = g_nat.align_local(s, params) if g_nat.n_nodes() else []
            assert a_nat == a_py
            poa.add_alignment(g_py, a_py, s)
            g_nat.add_alignment(a_nat, s)
        assert g_nat.msa() == g_py.msa()
        assert g_nat.n_nodes() == g_py.n_nodes()


def test_stale_library_is_rebuilt(lib, monkeypatch, tmp_path):
    """A recorded hash that differs from the source's rebuilds the library
    in place; an up-to-date one is kept as it is."""
    so = str(tmp_path / "librattle_native.so")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "SO", so)
    native._build()
    assert os.path.exists(so)
    built = os.path.getmtime(so)
    native._build()
    assert os.path.getmtime(so) == built
    with open(so + ".sha256", "w") as fh:
        fh.write("0" * 64 + "\n")
    os.utime(so, (built - 10, built - 10))
    native._build()
    assert os.path.getmtime(so) > built - 10
    with open(so + ".sha256") as fh:
        assert fh.read().strip() == native._source_hash()
