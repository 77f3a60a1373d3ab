"""The port's POA alignment (plain PyTorch version, the CPU path of
``poa_align``) vs the Pallas kernel in interpret mode and vs the executable
spec ``ops/poa.align_local``.

All integers: tolerance 0.  One batch at W = 1024, N = 4096 (the pack
engine's smallest config) holds every case, so the JAX side compiles and runs
once per module: the cases below and the adversarial graphs of
``rattle_tpu_torch.utils.synth.poa_cases`` (built for the JAX side with its
own ``ops/poa``), which chip_smoke.py also runs through the CUDA kernel.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rattle_tpu.ops import poa as jax_poa
from rattle_tpu.ops.poa_pallas import META_W, PMAX, poa_align_pallas
from rattle_tpu_torch.ops import kernels
from rattle_tpu_torch.ops import poa as port_poa
from rattle_tpu_torch.utils import synth
from tests.conftest import make_read, mutate

# The suite runs in several worker processes; with torch's default intra-op
# pool in each, the small CPU ops of the plain kernel versions oversubscribe
# the cores and run many times slower.
torch.set_num_threads(1)

W, N = 1024, 4096
# one adversarial graph per property it stresses (the module's own cases
# already hold empty-graph and inactive lanes; chip_smoke.py runs all of
# synth.POA_CASES through the CUDA kernel)
ADVERSARIAL = ("long_insertion_skip", "many_preds", "tied_preds",
               "long_chain", "short_read")
CASES = ("multi_pred", "multi_pred_long", "empty_graph", "inactive",
         "unrelated", "nothing_aligns", "identical", "single_read_graph",
         *(f"adv_{c}" for c in ADVERSARIAL))


def _grow(reads):
    g = jax_poa.POAGraph()
    p = jax_poa.POAParams()
    for s in reads:
        jax_poa.add_alignment(g, jax_poa.align_local(g, s, p), s)
    return g


def _lanes():
    """(graph, read, active) per case, from one numpy seed."""
    rng = np.random.default_rng(20240)
    ref = make_read(rng, 70)
    ref2 = make_read(rng, 160)
    ac = "".join(rng.choice(list("AC"), size=60))
    lanes = {
        "multi_pred": (_grow([mutate(rng, ref, 0.12) for _ in range(6)]),
                       mutate(rng, ref, 0.12), 1),
        "multi_pred_long": (_grow([mutate(rng, ref2, 0.1) for _ in range(5)]),
                            mutate(rng, ref2, 0.1), 1),
        "empty_graph": (jax_poa.POAGraph(), mutate(rng, ref, 0.1), 1),
        "inactive": (_grow([mutate(rng, ref, 0.1) for _ in range(3)]),
                     mutate(rng, ref, 0.1), 0),
        "unrelated": (_grow([mutate(rng, ref, 0.1) for _ in range(3)]),
                      make_read(rng, 90), 1),
        "nothing_aligns": (_grow([ac, ac[:50] + "CA"]),
                           "".join(rng.choice(list("GT"), size=40)), 1),
        "identical": (_grow([ref, ref]), ref, 1),
        "single_read_graph": (_grow([ref2]), mutate(rng, ref2, 0.15), 1),
    }
    for name, g, read, act in synth.poa_cases(jax_poa):
        if name in ADVERSARIAL:
            lanes[f"adv_{name}"] = (g, read, act)
    return [lanes[c] for c in CASES]


def _rank_arrays(g):
    _, order = g.topo_groups()
    rank_nodes = [nid for members in order for nid in members]
    rank_of = {nid: r for r, nid in enumerate(rank_nodes)}
    return rank_nodes, rank_of


@pytest.fixture(scope="module")
def batch():
    lanes = _lanes()
    b = len(lanes)
    meta = np.zeros((b, N, META_W), np.int16)
    meta[:, :, PMAX + 1] = 1
    rank_tab = np.zeros((b, N), np.int32)
    pred_rows = np.zeros((b, N, PMAX), np.int32)
    npred = np.ones((b, N), np.int32)
    letters = np.zeros((b, N), np.int32)
    n_nodes = np.zeros(b, np.int32)
    seq = np.zeros((b, W), np.uint8)
    seq_len = np.zeros(b, np.int32)
    active = np.zeros(b, np.int32)
    rank_nodes_of = []
    for li, (g, read, act) in enumerate(lanes):
        rank_nodes, rank_of = _rank_arrays(g)
        rank_nodes_of.append(rank_nodes)
        n_nodes[li] = len(rank_nodes)
        for r, nid in enumerate(rank_nodes):
            ins = g.in_edges[nid]
            assert len(ins) <= PMAX
            letters[li, r] = meta[li, r, PMAX] = ord(g.letters[nid])
            npred[li, r] = meta[li, r, PMAX + 1] = max(len(ins), 1)
            rank_tab[li, nid] = r
            for k, a in enumerate(ins):
                meta[li, r, k] = a + 1            # JAX: pred NODE + 1
                pred_rows[li, r, k] = rank_of[a] + 1   # port: pred ROW
        raw = np.frombuffer(read.encode("ascii"), np.uint8)
        seq[li, :len(raw)] = raw
        seq_len[li] = len(raw)
        active[li] = act

    # JAX: column j holds base j - 1
    seq_sh = np.zeros((b, W), np.int32)
    seq_sh[:, 1:] = seq[:, :W - 1]
    ref = poa_align_pallas(
        jnp.asarray(meta), jnp.asarray(n_nodes),
        jnp.asarray(seq_sh.reshape(b, W // 128, 128)), jnp.asarray(seq_len),
        jnp.asarray(active), jnp.asarray(rank_tab), interpret=True)
    ref = [np.asarray(x) for x in ref]

    # the lane's activity as a pack step: step 0 < n_reads = active, no
    # fallback
    args = [torch.from_numpy(x) for x in
            (pred_rows, npred, letters, n_nodes, seq, seq_len)]
    args += [0, torch.from_numpy(active), torch.zeros(b, dtype=torch.int32)]
    got = [x.numpy() for x in kernels.poa_align(*args)]
    plain = [x.numpy() for x in kernels.poa_align_plain(*args)]
    return dict(lanes=lanes, rank_nodes=rank_nodes_of, ref=ref, got=got,
                plain=plain, args=args)


def test_multi_pred_case_has_multi_pred_nodes(batch):
    npred = batch["args"][1].numpy()
    n = int(batch["args"][3][0])
    assert (npred[0, :n] > 1).sum() >= 3


@pytest.mark.parametrize("li", range(len(CASES)), ids=CASES)
def test_plain_equals_pallas_interpret(batch, li):
    (r_packed, r_tlen, r_best) = batch["ref"]
    (g_packed, g_tlen, g_best) = batch["got"]
    assert int(g_best[li]) == int(r_best[li])
    assert int(g_tlen[li]) == int(r_tlen[li])
    cnt = int(r_tlen[li])
    assert np.array_equal(g_packed[li, :cnt], r_packed[li, :cnt])
    # the CPU path of the wrapper IS the plain version
    for a, b in zip(batch["got"], batch["plain"]):
        assert np.array_equal(a[li], b[li])


@pytest.mark.parametrize("li", range(len(CASES)), ids=CASES)
def test_plain_equals_align_local(batch, li):
    g, read, act = batch["lanes"][li]
    packed, tlen, best = batch["got"]
    cnt = int(tlen[li])
    words = packed[li, :cnt][::-1]
    moves = [(batch["rank_nodes"][li][(int(x) >> 16) - 1], (int(x) & 0xFFFF) - 1)
             for x in words]
    if not act or g.n_nodes() == 0:
        assert cnt == 0 and int(best[li]) == 0
        return
    aln = jax_poa.align_local(g, read, jax_poa.POAParams())
    want = [(nid, sp) for nid, sp in aln if nid != -1 and sp != -1]
    assert moves == want
    assert (cnt == 0) == (int(best[li]) == 0)
    if CASES[li] == "nothing_aligns":
        assert cnt == 0
    if CASES[li] in ("multi_pred", "identical", "multi_pred_long"):
        assert cnt > 30


def test_adversarial_cases(batch):
    """The port builds the same adversarial graphs and rank-space arrays as
    the batch's (which come from the reference's graphs), and each graph
    stresses what it is named for."""
    pred_rows, npred, letters = (x.numpy() for x in batch["args"][:3])
    n_nodes = batch["args"][3].numpy()
    for name, g, read, act in synth.poa_cases():
        if name not in ADVERSARIAL:
            continue
        li = CASES.index(f"adv_{name}")
        pr, npr, let, _ = synth.rank_arrays(g, N)
        assert np.array_equal(pr, pred_rows[li]), name
        assert np.array_equal(npr, npred[li]), name
        assert np.array_equal(let, letters[li]), name
        assert read == batch["lanes"][li][1] and act == batch["lanes"][li][2]

    def lane(name):
        li = CASES.index(f"adv_{name}")
        n = int(n_nodes[li])
        back = [r + 1 - pred_rows[li, r, k] for r in range(n)
                for k in range(npred[li, r]) if pred_rows[li, r, k] > 0]
        return li, n, max(back, default=0)

    assert lane("long_insertion_skip")[2] > 40      # beyond any row ring
    li, n, back = lane("many_preds")
    assert npred[li, :n].max() == kernels.POA_PMAX and back > 16
    li, n, _ = lane("long_chain")
    assert n == 400 and npred[li, :n].max() == 1
    assert int(batch["args"][5][CASES.index("adv_short_read")]) == 20


def test_port_poa_copy_matches_source():
    """ops/poa.py is a copy: same MSA rows on a random pack."""
    rng = np.random.default_rng(5)
    ref = make_read(rng, 50)
    reads = [mutate(rng, ref, 0.1) for _ in range(5)]
    assert port_poa.poa_msa(reads) == jax_poa.poa_msa(reads)


def test_poa_align_rejects_bad_inputs(batch):
    args = list(batch["args"])
    with pytest.raises(ValueError):
        kernels.poa_align(args[0], args[1], args[2].to(torch.int64),
                          *args[3:])
    with pytest.raises(ValueError):
        kernels.poa_align(*args[:4], args[4][:, :1000].contiguous(),
                          *args[5:])


def test_poa_align_reads_the_pack_step_in_place(batch):
    """The read as a row-strided view of a pack's [B, R, W] reads, its
    length as a strided column, and the lanes' activity from a later step
    t, n_reads and fallback: the same outputs as contiguous inputs at step
    0."""
    (pred_rows, npred, letters, n_nodes, seq, seq_len, _step, active,
     _fallback) = batch["args"]
    b = seq.shape[0]
    t = 1
    seqs = torch.zeros((b, 3, W), dtype=torch.uint8)
    seqs[:, t] = seq
    lens = torch.zeros((b, 3), dtype=torch.int32)
    lens[:, t] = seq_len
    # active lanes: t < n_reads and no fallback; the others one or the other
    n_reads = torch.where(active > 0, 3, 1).to(torch.int32)
    fallback = torch.where(torch.arange(b) % 2 == 0, 0, 4).to(torch.int32)
    fallback = torch.where(active > 0, 0, fallback).to(torch.int32)
    got = kernels.poa_align(pred_rows, npred, letters, n_nodes,
                            seqs[:, t, :], lens[:, t], t, n_reads, fallback)
    want = kernels.poa_align(*batch["args"])
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


def test_poa_align_rejects_bad_step_inputs(batch):
    pred_rows, npred, letters, n_nodes, seq, seq_len = batch["args"][:6]
    b = seq.shape[0]
    flags = torch.zeros(b, dtype=torch.int32)
    with pytest.raises(ValueError):   # a column stride other than 1
        kernels.poa_align(pred_rows, npred, letters, n_nodes,
                          seq.t().contiguous().t(), seq_len, 0, flags + 1,
                          flags)
    with pytest.raises(ValueError):   # n_reads of another lane count
        kernels.poa_align(pred_rows, npred, letters, n_nodes, seq, seq_len,
                          0, flags[:1], flags)
