"""The port's pack engine on the CPU vs the JAX pack engine (Pallas kernel in
interpret mode) and the ``ops/poa`` oracle, with the packs of
tests/test_pack_engine.py.  MSA rows and statistics are compared exactly.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rattle_tpu.correct import pack_engine as jax_pe
from rattle_tpu.correct import tpu_runner as jax_runner
from rattle_tpu.ops import poa as jax_poa
from rattle_tpu_torch.correct import pack_engine as pe
from rattle_tpu_torch.correct import runner
from rattle_tpu_torch.ops import poa as port_poa
from tests.test_pack_engine import _oracle_msa, _random_pack

# The suite runs in several worker processes; with torch's default intra-op
# pool in each, the small CPU ops of the plain kernel versions oversubscribe
# the cores and run many times slower.
torch.set_num_threads(1)

STAT_KEYS = ("device_packs", "fallback_packs", "device_bases", "host_bases",
             "fb_length", "fb_reads", "fb_node_cap", "fb_pred_cap",
             "fb_group_cap")


def _packs():
    rng = random.Random(0)
    packs = [_random_pack(rng, rng.randint(2, 6), rng.randint(10, 70), 10)
             for _ in range(6)]
    rng = random.Random(7)
    packs += [
        ["ACGTACGTAA"] * 3,
        ["A" * 40, "A" * 38 + "GG", "CC" + "A" * 37],
        ["ACGT" * 10, "TTTT" * 9, "GACA" * 8],
        _random_pack(rng, 5, 60, 12),
        [],
    ]
    return packs


def _over_capacity_packs():
    """One pack with a read of 4,100 bases (fb_length) and one of 257 reads
    (fb_reads); both must run on the host aligner."""
    rng = random.Random(3)
    long_ref = "".join(rng.choice("ACGT") for _ in range(4100))
    long_pack = [long_ref, long_ref[:2000] + "T" + long_ref[2001:4050]]
    many = _random_pack(rng, 257, 24, 3)
    return [long_pack, many]


@pytest.fixture(scope="module")
def engines():
    """Both engines run once over the same packs (device packs in lane
    groups of 8, plus the two over-capacity packs through the host
    aligner)."""
    packs = _packs() + _over_capacity_packs()
    jp = jax_poa.POAParams()
    jax_eng = jax_pe.PackEngine(max_lanes=8)
    want = jax_eng.msa_many(
        packs, host_fn=lambda s: jax_runner._host_msa(s, jp))
    port_eng = pe.PackEngine(device="cpu", max_lanes=8)
    got = port_eng.msa_many(
        packs, host_fn=lambda s: runner._host_msa(s, port_poa.POAParams()))
    return dict(packs=packs, want=want, got=got, jax=jax_eng, port=port_eng)


@pytest.mark.parametrize("i", range(13))
def test_rows_equal_jax_engine_and_oracle(engines, i):
    pack = engines["packs"][i]
    assert engines["got"][i] == engines["want"][i]
    if i < 11 and pack:       # device packs: also the Python oracle's rows
        assert engines["got"][i] == _oracle_msa(pack)


@pytest.mark.parametrize("key", STAT_KEYS)
def test_stats_equal_jax_engine(engines, key):
    assert engines["port"].stats[key] == engines["jax"].stats[key]


def test_over_capacity_packs_are_counted_by_cause(engines):
    st = engines["port"].stats
    assert st["fb_length"] == 1 and st["fb_reads"] == 1
    assert st["fallback_packs"] == 2 and st["device_packs"] == 10
    assert st["host_bases"] == sum(
        len(s) for p in engines["packs"][11:] for s in p)
    assert len(engines["got"][11]) == 2 and len(engines["got"][12]) == 257


def test_fallback_without_host_fn_returns_none():
    eng = pe.PackEngine(device="cpu")
    packs = _over_capacity_packs()[1:] + [["ACGTAC", "ACGAC"]]
    got = eng.msa_many(packs)
    assert got[0] is None and got[1] == _oracle_msa(packs[1])
    assert eng.stats["fb_reads"] == 1 and eng.stats["device_packs"] == 1


def test_batched_msa_raises_on_a_missing_msa():
    class NoHost(pe.PackEngine):
        def msa_many(self, all_seqs, host_fn=None, **kw):
            return super().msa_many(all_seqs, host_fn=None, **kw)

    with pytest.raises(RuntimeError, match="no MSA"):
        runner.batched_msa(_over_capacity_packs()[1:], port_poa.POAParams(),
                           NoHost(device="cpu"))


def test_batched_msa_updates_last_stats():
    packs = [["ACGTACGT", "ACGTTACGT"], ["TTGACA", "TTGCA", "TGACA"]]
    eng = pe.PackEngine(device="cpu")
    rows = runner.batched_msa(packs, port_poa.POAParams(), eng)
    assert rows == [_oracle_msa(p) for p in packs]
    assert runner.LAST_STATS["device_packs"] == 2
    assert runner.LAST_STATS["device_bases"] == sum(
        len(s) for p in packs for s in p)


def test_node_cap_overflow_falls_back(monkeypatch):
    """A graph that outgrows N goes to the host by cause node_cap, with the
    oracle's rows (a 64-node config stands in for the real caps)."""
    monkeypatch.setattr(pe, "CONFIGS", ((1024, 64, 8),))
    rng = random.Random(11)
    packs = [_random_pack(rng, 4, 70, 10), ["ACGT" * 5, "ACGT" * 5]]
    eng = pe.PackEngine(device="cpu")
    got = eng.msa_many(
        packs, host_fn=lambda s: runner._host_msa(s, port_poa.POAParams()))
    assert eng.stats["fb_node_cap"] == 1 and eng.stats["device_packs"] == 1
    assert got[1] == _oracle_msa(packs[1])
    assert len(got[0]) == 4


# --------------------------------------------------------------------------
# one step from an injected JAX state
# --------------------------------------------------------------------------

STEP_FIELDS = ("letters", "npred", "preds", "node_rank", "perm", "path",
               "n_nodes", "n_groups", "grp_leader", "member_idx", "grp_size",
               "grp_pos", "fallback")


@pytest.fixture(scope="module")
def stepped():
    """The JAX engine's state after 2 read steps and after 3, for 8 lanes
    (the shapes of the engine's own group above), and the port's state after
    taking the third step from the injected JAX state."""
    rng = random.Random(1)
    packs = [_random_pack(rng, rng.randint(3, 6), rng.randint(40, 70), 10)
             for _ in range(6)]
    b, w, n_cap, r_cap, tot_cap = 8, 1024, 4096, 32, 4096
    seqs = np.zeros((b, r_cap, w), np.int8)
    lens = np.zeros((b, r_cap), np.int32)
    n_reads = np.zeros(b, np.int32)
    for li, pack in enumerate(packs):
        for t, s in enumerate(pack):
            raw = np.frombuffer(s.encode("ascii"), np.uint8)
            seqs[li, t, :len(raw)] = raw
            lens[li, t] = len(raw)
        n_reads[li] = len(pack)
    st = jax_pe._init_state(jnp.asarray(seqs), jnp.asarray(lens),
                            jnp.asarray(n_reads), n_cap=n_cap, r_cap=r_cap,
                            tot_cap=tot_cap)
    for t in range(2):
        st = jax_pe._step(st, jnp.int32(t), w_eff=w, match=5, mismatch=-4,
                          go=-8, ge=-6)
    before = {k: np.asarray(v) for k, v in st.items()}
    st = jax_pe._step(st, jnp.int32(2), w_eff=w, match=5, mismatch=-4,
                      go=-8, ge=-6)
    after = {k: np.asarray(v) for k, v in st.items()}
    port = pe._step(pe.pack_state_from_numpy(before, device="cpu"), 2,
                   w_eff=w)
    return dict(after=after, port=port, n_cap=n_cap, tot_cap=tot_cap)


@pytest.mark.parametrize("field", STEP_FIELDS)
def test_one_step_from_injected_jax_state(stepped, field):
    want = stepped["after"][field]
    got = stepped["port"][field].numpy()
    n_cap = stepped["n_cap"]
    n_nodes = stepped["after"]["n_nodes"]
    assert n_nodes.max() > 40
    if field == "path":
        got = got[:, :stepped["tot_cap"]]
    elif got.ndim >= 2 and got.shape[1] == n_cap + 1:
        got = got[:, :n_cap]           # drop the spare slot
    if field == "perm":                # defined for ranks below n_nodes
        for li, nn in enumerate(n_nodes):
            assert np.array_equal(got[li, :nn], want[li, :nn])
        return
    if field in ("letters", "npred", "preds", "grp_leader", "member_idx",
                 "grp_size"):          # per node: defined below n_nodes
        for li, nn in enumerate(n_nodes):
            assert np.array_equal(got[li, :nn], want[li, :nn]), li
        return
    if field == "grp_pos":             # read through grp_leader only
        lead = stepped["after"]["grp_leader"]
        for li, nn in enumerate(n_nodes):
            assert np.array_equal(got[li][lead[li, :nn]],
                                  want[li][lead[li, :nn]])
        return
    assert np.array_equal(got, want)


def test_pack_state_from_numpy_pads_scatter_targets():
    state = dict(letters=np.ones((2, 8), np.int32),
                 preds=np.zeros((2, 8, 16), np.int32),
                 node_rank=np.zeros((2, 8), np.int32),
                 seqs=np.full((2, 3, 128), 65, np.int8),
                 n_nodes=np.zeros(2, np.int32))
    st = pe.pack_state_from_numpy(state, device="cpu")
    assert st["letters"].shape == (2, 9) and int(st["letters"][0, 8]) == 0
    assert st["preds"].shape == (2, 9, 16) and int(st["preds"][1, 8, 0]) == -1
    assert st["node_rank"].shape == (2, 8)
    assert st["seqs"].dtype == torch.uint8 and st["n_nodes"].shape == (2,)
