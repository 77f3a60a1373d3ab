"""The port's pack engine on the CPU vs the JAX pack engine (Pallas kernel in
interpret mode) and the ``ops/poa`` oracle, with the packs of
tests/test_pack_engine.py.  MSA rows and statistics are compared exactly, and
so is the read step (poa_align -> poa_thread -> poa_rerank on their plain
versions) against the JAX engine's jitted ``_step``: every state field after
one step from an injected JAX state, and after each of 18 consecutive steps
of a group with idle lanes and one lane for each fallback cause.  The keys
of those steps, and hand-made and random keys, hold the premise of
poa_rerank's order by counting against a stable torch.sort.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rattle_tpu.correct import pack_engine as jax_pe
from rattle_tpu_torch.correct import pack_engine as pe
from rattle_tpu_torch.correct import runner
from rattle_tpu_torch.ops import kernels
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
    aligner).  The JAX side's host packs go to ops/poa.py: its host aligner
    loads the native library committed in native/, which is older than
    its source, while the port's builds its own from the source."""
    packs = _packs() + _over_capacity_packs()
    jax_eng = jax_pe.PackEngine(max_lanes=8)
    want = jax_eng.msa_many(packs, host_fn=_oracle_msa)
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


# --------------------------------------------------------------------------
# consecutive steps of the port's step against the JAX engine's _step, with
# a lane that falls back on each cause and idle lanes
# --------------------------------------------------------------------------

N_SMALL = 1024         # node cap of the group (the JAX kernel's least)
W_STEP = 1024
# letters of the adversarial reads beyond ACGT: each read brings new ones,
# so they align to nothing
_RARE = "abcdefghijklmnopqrstuvwxyz"


def _adversarial_lanes():
    """(name, reads) of the 8 lanes of one group: three normal packs, a
    pack that goes idle after 2 reads, an empty lane, and one lane for each
    fallback cause (node cap: 400-base reads, each over letters of its own,
    against N_SMALL nodes; pred cap: 18 reads whose first shared node gets a new
    predecessor from each; group cap: 9 reads with a new letter at one
    aligned column)."""
    rng = random.Random(5)
    shared = "".join(rng.choice("ACGT") for _ in range(20))
    left = "".join(rng.choice("ACGT") for _ in range(15))
    right = "".join(rng.choice("ACGT") for _ in range(15))
    return [
        ("normal0", _random_pack(rng, 6, 60, 8)),
        ("normal1", _random_pack(rng, 5, 45, 8)),
        ("normal2", _random_pack(rng, 6, 50, 6)),
        ("idle_after_2", _random_pack(rng, 2, 40, 5)),
        ("empty", []),
        ("node_cap", ["".join(rng.choice(_RARE[2 * i:2 * i + 2])
                              for _ in range(400)) for i in range(4)]),
        ("pred_cap", [_RARE[i] + _RARE[i + 1] + _RARE[i + 2] + shared
                      for i in range(0, 18)]),
        ("group_cap", [left + _RARE[i] + right for i in range(9)]),
    ]


CAUSE_BITS = {"node_cap": 1, "pred_cap": 2, "group_cap": 4}
RANK_SPACE = ("pred_rows", "npred_r", "letters_r")


def _assert_state_equal(field, want, got, n_nodes, lead, tot_cap, what):
    """The port's field against the JAX engine's over its defined range
    (per node below n_nodes, grp_pos through grp_leader, path below
    tot_cap; the spare slot dropped)."""
    if field == "path":
        got = got[:, :tot_cap]
    elif field in pe.RANK_FIELDS or field == "node_rank":
        pass
    elif got.ndim >= 2 and got.shape[1] == want.shape[1] + 1:
        got = got[:, :-1]
    for li, nn in enumerate(n_nodes):
        if field in ("letters", "npred", "preds", "grp_leader", "member_idx",
                     "grp_size", "perm") + pe.RANK_FIELDS:
            g, w_ = got[li, :nn], want[li, :nn]
        elif field == "grp_pos":
            g, w_ = got[li][lead[li, :nn]], want[li][lead[li, :nn]]
        else:
            g, w_ = got[li], want[li]
        assert np.array_equal(g, w_), f"{what}: {field}, lane {li}"


@pytest.fixture(scope="module")
def consecutive():
    """The adversarial group stepped by the JAX engine's _step and by the
    port's (its plain kernels on the CPU) from the same initial state: the
    numpy state of both after every step, and the rank space of the JAX
    state after every step."""
    lanes = _adversarial_lanes()
    b = len(lanes)
    r_max = max(len(reads) for _n, reads in lanes)
    seqs = np.zeros((b, r_max, W_STEP), np.uint8)
    lens = np.zeros((b, r_max), np.int32)
    n_reads = np.zeros(b, np.int32)
    for li, (_name, reads) in enumerate(lanes):
        for t, s in enumerate(reads):
            seqs[li, t, :len(s)] = np.frombuffer(s.encode("ascii"), np.uint8)
            lens[li, t] = len(s)
        n_reads[li] = len(reads)
    tot_cap = int(lens.sum(axis=1).max())
    jst = jax_pe._init_state(jnp.asarray(seqs.astype(np.int8)),
                             jnp.asarray(lens), jnp.asarray(n_reads),
                             n_cap=N_SMALL, r_cap=r_max, tot_cap=tot_cap)
    pst = pe._init_state(torch.from_numpy(seqs), torch.from_numpy(lens),
                         torch.from_numpy(n_reads), n_cap=N_SMALL,
                         tot_cap=tot_cap)
    steps = []
    for t in range(r_max):
        jst = jax_pe._step(jst, jnp.int32(t), w_eff=W_STEP, match=5,
                           mismatch=-4, go=-8, ge=-6)
        pe._step(pst, t, w_eff=W_STEP)
        want = {k: np.asarray(v) for k, v in jst.items()}
        ranks = pe.rank_space(pe.pack_state_from_numpy(want, device="cpu"))
        want.update((f, x.numpy()) for f, x in zip(pe.RANK_FIELDS, ranks))
        steps.append((want, {k: v.numpy().copy() for k, v in pst.items()}))
    return dict(lanes=[n for n, _r in lanes], steps=steps, tot_cap=tot_cap)


@pytest.mark.parametrize("field", STEP_FIELDS + RANK_SPACE)
def test_consecutive_steps_equal_jax(consecutive, field):
    """Every state field, and the rank-space inputs poa_rerank writes for
    the next step, after each step of the group."""
    for t, (want, got) in enumerate(consecutive["steps"]):
        _assert_state_equal(field, want[field], got[field], want["n_nodes"],
                            want["grp_leader"], consecutive["tot_cap"],
                            f"step {t}")


@pytest.mark.parametrize("cause", sorted(CAUSE_BITS))
def test_each_cap_overflows_like_jax(consecutive, cause):
    """The lane built to pass one cap falls back on that cause alone, at the
    same step as in the JAX engine, and its state then stays put."""
    li = consecutive["lanes"].index(cause)
    fb = [int(want["fallback"][li]) for want, _g in consecutive["steps"]]
    got = [int(g["fallback"][li]) for _w, g in consecutive["steps"]]
    assert got == fb and fb[-1] == CAUSE_BITS[cause]
    first = fb.index(CAUSE_BITS[cause])
    after = [g["n_nodes"][li] for _w, g in consecutive["steps"][first:]]
    assert len(set(after)) == 1


@pytest.mark.parametrize("lane", ["idle_after_2", "empty"])
def test_idle_lanes_stay_put(consecutive, lane):
    """A lane past its last read, and a lane with no read, keep their state
    (the re-rank still runs on them) and never fall back."""
    li = consecutive["lanes"].index(lane)
    steps = consecutive["steps"]
    start = 2 if lane == "idle_after_2" else 0
    ref = steps[start - 1][1] if start else None
    for want, got in steps[start:]:
        assert got["fallback"][li] == 0
        if ref is None:
            assert got["n_nodes"][li] == 0 and got["n_groups"][li] == 0
            continue
        for f in ("n_nodes", "n_groups", "node_rank", "perm", "grp_pos",
                  "letters", "preds") + pe.RANK_FIELDS:
            assert np.array_equal(got[f][li], ref[f][li]), f


# --------------------------------------------------------------------------
# the premise of poa_rerank's order by counting (csrc/poa_rerank.cu): the
# keys poa_thread writes are a merge of two sorted runs, so a count gives
# their stable order; a numpy copy of the kernel's check and count
# --------------------------------------------------------------------------

SK, HALF, BIG = kernels.POA_SK, kernels.POA_HALF, kernels.POA_BIG


def _classes(keys, nn):
    """ids below nn of class A (an old leader, x * SK + HALF) and C (a new
    group's leader, g * SK + r, r < HALF), and every key below nn."""
    k = np.asarray(keys[:nn], np.int64)
    lead = (k >= 0) & (k < BIG)
    is_a = lead & (k % SK == HALF)
    return np.flatnonzero(is_a), np.flatnonzero(lead & ~is_a), k


def _structure_faults(keys, nn, g):
    """The conditions of the kernel's check that one lane's keys fail."""
    ids_a, ids_c, k = _classes(keys, nn)
    x = k[ids_a] // SK
    faults = set()
    if (k < 0).any():
        faults.add("negative")
    if len(ids_a) + len(ids_c) != g:
        faults.add("count")
    if len(np.unique(x)) < len(x):
        faults.add("repeat_x")
    if len(x) and x.max() >= len(x):
        faults.add("x_range")
    if (np.diff(k[ids_c]) < 0).any():
        faults.add("decreasing_c")
    return faults


def _counting_order(keys, nn, g):
    """The first g ids of the stable order of a lane's keys by counting:
    the k-th C in id order at k + min(g_k, |A|), the A at x at x + #{C :
    min(g_k, |A|) <= x}."""
    ids_a, ids_c, k = _classes(keys, nn)
    n_a = len(ids_a)
    x = k[ids_a] // SK
    gc = np.minimum(k[ids_c] // SK, n_a)
    at_or_before = np.cumsum(np.bincount(gc[gc < n_a], minlength=n_a))
    order = np.full(g, -1, np.int64)
    order[np.arange(len(ids_c)) + gc] = ids_c
    order[x + at_or_before[x]] = ids_a
    return order


def _sorted_order(keys, n, g):
    return torch.sort(torch.from_numpy(np.ascontiguousarray(keys[:n])),
                      stable=True).indices[:g].numpy()


@pytest.mark.parametrize("lane", ["normal0", "normal1", "normal2",
                                  "idle_after_2", "empty", "node_cap",
                                  "pred_cap", "group_cap"])
def test_rerank_keys_are_two_sorted_runs(consecutive, lane):
    """After every step of the group, each lane's keys pass the kernel's
    check (ids from n_nodes on key BIG), and the order by counting is
    torch.sort's stable order, the one grp_pos holds."""
    li = consecutive["lanes"].index(lane)
    for t, (_want, got) in enumerate(consecutive["steps"]):
        keys = got["keys"][li]
        n = got["node_rank"].shape[1]
        nn, g = int(got["n_nodes"][li]), int(got["n_groups"][li])
        assert not _structure_faults(keys, nn, g), f"step {t}"
        assert (keys[nn:n] == BIG).all(), f"step {t}"
        order = _counting_order(keys, nn, g)
        assert np.array_equal(order, _sorted_order(keys, n, g)), f"step {t}"
        assert np.array_equal(got["grp_pos"][li][order], np.arange(g))


def _hand_keys():
    """One lane's keys with the structure: 12 ids, old leaders at
    positions 3, 0, 2, 1, new groups before positions 0, 2, 2 (the last
    two one run) and 4, the rest BIG; G = 8."""
    keys = np.full(12, BIG, np.int32)
    for i, x in zip((0, 2, 5, 9), (3, 0, 2, 1)):
        keys[i] = x * SK + HALF
    for i, (g, r) in zip((3, 4, 6, 10), ((0, 0), (2, 0), (2, 1), (4, 0))):
        keys[i] = g * SK + r
    return keys, 12, 8


def test_rerank_counting_order_on_hand_made_keys():
    keys, nn, g = _hand_keys()
    assert not _structure_faults(keys, nn, g)
    order = _counting_order(keys, nn, g)
    assert order.tolist() == [3, 2, 9, 4, 6, 5, 0, 10]
    assert np.array_equal(order, _sorted_order(keys, nn, g))


@pytest.mark.parametrize("fault", ["repeat_x", "decreasing_c", "count",
                                   "negative", "x_range"])
def test_rerank_check_flags_broken_keys(fault):
    """Keys that break one condition of the check are flagged by it alone
    (the kernel sorts such a lane)."""
    keys, nn, g = _hand_keys()
    if fault == "repeat_x":           # positions 3, 0, 0, 1
        keys[5] = keys[2]
    elif fault == "decreasing_c":     # the run's keys in reverse id order
        keys[4], keys[6] = keys[6], keys[4]
    elif fault == "count":            # one group more than the leaders
        g += 1
    elif fault == "negative":         # a node that leads nothing
        keys[1] = -1
    elif fault == "x_range":          # positions 3, 0, 5, 1
        keys[5] = 5 * SK + HALF
    assert _structure_faults(keys, nn, g) == {fault}


@pytest.mark.parametrize("seed", range(4))
def test_rerank_counting_order_equals_stable_sort(seed):
    """Random keys with the structure, C runs long enough to tie at the
    clipped run index: the order by counting is the stable sort's."""
    rng = np.random.default_rng(seed)
    n_a, n_c, n_other = rng.integers(0, 300, size=3)
    nn = int(n_a + n_c + n_other)
    ids = rng.permutation(nn)
    ids_a, ids_c = ids[:n_a], np.sort(ids[n_a:n_a + n_c])
    keys = np.full(nn + 5, BIG, np.int32)
    keys[ids_a] = rng.permutation(n_a) * SK + HALF
    gs = np.sort(rng.integers(0, n_a + 1, size=n_c))
    runs = np.minimum(rng.integers(0, 2 * HALF, size=n_c), HALF - 1)
    for k in range(1, n_c):             # run indices climb within a g
        if gs[k] == gs[k - 1]:
            runs[k] = min(max(runs[k], runs[k - 1]), HALF - 1)
    keys[ids_c] = gs * SK + runs
    g = int(n_a + n_c)
    assert not _structure_faults(keys, nn, g)
    assert np.array_equal(_counting_order(keys, nn, g),
                          _sorted_order(keys, nn + 5, g))


def _small_state():
    """The port's state of a 2-lane group of short packs, after one step."""
    packs = [["ACGTACGTAA", "ACGTTCGTAA"], ["TTGACA", "TTGCA"]]
    b, w = len(packs), 128
    seqs = np.zeros((b, 2, w), np.uint8)
    lens = np.zeros((b, 2), np.int32)
    for li, pack in enumerate(packs):
        for t, s in enumerate(pack):
            seqs[li, t, :len(s)] = np.frombuffer(s.encode("ascii"), np.uint8)
            lens[li, t] = len(s)
    st = pe._init_state(torch.from_numpy(seqs), torch.from_numpy(lens),
                        torch.tensor([2, 2], dtype=torch.int32), n_cap=64,
                        tot_cap=int(lens.sum(axis=1).max()))
    return pe._step(st, 0, w_eff=w)


@pytest.mark.parametrize("bad", ["keys_dtype", "width", "step", "n_cap",
                                 "rank_rows"])
def test_step_kernels_reject_bad_state(bad):
    """poa_thread and poa_rerank check the state's types and shapes the way
    poa_align checks its inputs."""
    st = _small_state()
    packed = torch.zeros((2, 128), dtype=torch.int32)
    zeros = torch.zeros(2, dtype=torch.int32)
    t, w = 1, 128
    if bad == "keys_dtype":
        st["keys"] = st["keys"].to(torch.int64)
    elif bad == "width":
        w = 256
        packed = torch.zeros((2, 256), dtype=torch.int32)
    elif bad == "step":
        t = 2
    elif bad == "n_cap":
        for f in ("letters", "npred", "grp_leader", "member_idx", "grp_size",
                  "grp_pos", "perm", "keys"):
            st[f] = torch.zeros((2, kernels.POA_MAX_N + 2), dtype=torch.int32)
    elif bad == "rank_rows":
        st["pred_rows"] = st["pred_rows"][:, :-1].contiguous()
    with pytest.raises(ValueError):
        if bad == "rank_rows":
            kernels.poa_rerank(st)
        else:
            kernels.poa_thread(st, t, w, packed, zeros, zeros)


def test_step_keeps_the_rank_space_between_steps():
    """After a step the state holds the next step's poa_align inputs,
    equal to rank_space of the new state for the ranks below n_nodes."""
    st = _small_state()
    want = pe.rank_space(st)
    nn = st["n_nodes"]
    for f, x in zip(pe.RANK_FIELDS, want):
        for li in range(2):
            assert torch.equal(st[f][li, :nn[li]], x[li, :nn[li]]), f
