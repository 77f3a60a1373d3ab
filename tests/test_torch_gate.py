"""``cluster``'s decision wave in the port against the JAX package on the
CPU: the gate (``kernels.gate_block_plain``, the plain version of the
gate_block kernel) against JAX's jitted ``gate_class_block``, the port's
``tier_partition`` against JAX's, and the engine's device->host reads
against its rule (at most two a strand and one a wave outside the rare
paths) with its clusters equal to the oracle's.  The CUDA kernels
themselves are held against these plain versions on the card by
chip_smoke.py phase 2b."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rattle_tpu.cluster import bulk as jbulk
from rattle_tpu_torch.cluster import bulk, oracle
from rattle_tpu_torch.cluster.bulk import BulkClusterEngine
from rattle_tpu_torch.config import ClusterParams
from rattle_tpu_torch.ops import gates, kernels
from rattle_tpu_torch.utils import metrics
from tests.conftest import make_read, mutate

# the plain versions are many small torch ops; the run has several workers
torch.set_num_threads(1)

N_READS = 160
BOUNDS = np.array([1024, 2048, 4096], np.int32)     # four K classes


def _planes(rng, n, n_fam=8, density=0.3):
    """[n, 4096] uint8 6-mer planes of n reads from n_fam families: each a
    family's plane thinned and salted, so that members pass the gate."""
    base = rng.random((n_fam, 4096)) < density
    fam = rng.integers(0, n_fam, n)
    keep = rng.random((n, 4096)) < 0.8
    salt = rng.random((n, 4096)) < 0.05
    return ((base[fam] & keep) | salt).astype(np.uint8)


def _pack(plane):
    """[n, 4096] 0/1 -> [n, 128] int32 words (bit h at word h >> 5, bit
    h & 31: ops/sketch.py's order)."""
    bits = plane.reshape(plane.shape[0], 128, 32).astype(np.uint64)
    words = (bits << np.arange(32, dtype=np.uint64)).sum(axis=2)
    return words.astype(np.uint32).view(np.int32)


def _gate_inputs(case):
    """One gate's inputs, numpy, from one seed: rows x cols of N_READS reads
    (global ids), their planes (the columns' from a second set for the
    reverse strand), orders, groups, the threshold table, the score cache
    (or None), w, the strand value and nk."""
    rng = np.random.default_rng(13)
    fwd = _planes(rng, N_READS)
    # the reverse strand's planes: the forward ones thinned again
    rev = fwd & (rng.random(fwd.shape) < 0.9).astype(np.uint8)
    nk = rng.integers(200, 6000, N_READS).astype(np.int32)
    ids = rng.permutation(N_READS)
    if case == "sweep":
        row_ids, col_ids = ids[:30], ids[30:]
    else:
        row_ids = col_ids = ids[:96]
    a, c = len(row_ids), len(col_ids)
    if case == "sweep":
        order_r, order_c = np.zeros(a, np.int32), np.ones(c, np.int32)
    else:
        order_r, order_c = np.arange(a, dtype=np.int32), \
            np.arange(c, dtype=np.int32)
    groups = rng.integers(0, 4, N_READS).astype(np.int32) \
        if case == "groups" else np.zeros(N_READS, np.int32)
    tab = gates.min_numerator_table(4096, 0.4)
    if case == "nothing":
        tab = np.full(4097, 4097, np.int32)
    cache = None
    if case in ("cache", "reverse"):
        cache = rng.choice(np.array([0, 1, 2], np.uint8), N_READS ** 2,
                           p=[0.5, 0.25, 0.25])
    w = np.zeros((a, c), np.int8)
    if case == "reverse":
        w = rng.choice(np.array([0, 1, 2], np.int8), (a, c),
                       p=[0.9, 0.05, 0.05])
    col_planes = rev if case == "reverse" else fwd
    return dict(rows_p=fwd[row_ids], cols_p=col_planes[col_ids],
                bvc_r=fwd[row_ids].sum(1, dtype=np.int32),
                bvc_c=fwd[col_ids].sum(1, dtype=np.int32),
                order_r=order_r, order_c=order_c, group_r=groups[row_ids],
                group_c=groups[col_ids], tab=tab, cache=cache,
                row_ids=row_ids, col_ids=col_ids, w=w,
                strand_val=1 if case == "reverse" else 2, nk=nk)


def _jax_gate(x):
    """JAX's gate_class_block on the inputs: (w, rows, cols, class
    counts), the pairs decoded from rc_flat by the columns' count."""
    a, c = x["w"].shape
    budget = 1 << max(10, (a * c - 1).bit_length())
    cache = x["cache"]
    n_pad = N_READS
    if cache is None:       # the JAX engine's cache-free form
        cache, n_pad = np.zeros(1, np.uint8), 1
    w, rc, _total, counts = jbulk.gate_class_block(
        jnp.asarray(x["rows_p"]), jnp.asarray(x["bvc_r"]),
        jnp.asarray(x["order_r"]), jnp.asarray(x["group_r"]), jnp.int32(a),
        jnp.asarray(x["cols_p"]), jnp.asarray(x["bvc_c"]),
        jnp.asarray(x["order_c"]), jnp.asarray(x["group_c"]), jnp.int32(c),
        jnp.asarray(x["tab"]), jnp.asarray(cache),
        jnp.asarray(x["row_ids"].astype(np.int32)),
        jnp.asarray(x["col_ids"].astype(np.int32)), jnp.asarray(x["w"]),
        jnp.int8(x["strand_val"]), jnp.asarray(x["nk"]), jnp.asarray(BOUNDS),
        budget=budget, n_pad=n_pad, n_classes=len(BOUNDS) + 1)
    counts = np.asarray(counts)
    rc = np.asarray(rc)[:int(counts.sum())]
    return np.asarray(w), rc // c, rc % c, counts


def _port_args(x):
    t = torch.from_numpy
    cache = None if x["cache"] is None else t(x["cache"].copy())
    return [t(_pack(x["rows_p"])), t(x["bvc_r"]), t(x["order_r"]),
            t(x["group_r"]), t(_pack(x["cols_p"])), t(x["bvc_c"]),
            t(x["order_c"]), t(x["group_c"]), t(x["tab"]), cache, N_READS,
            t(x["row_ids"].astype(np.int64)),
            t(x["col_ids"].astype(np.int64)), t(x["w"].copy()),
            x["strand_val"], t(x["nk"]), t(BOUNDS)]


@pytest.mark.parametrize("case", ["block", "sweep", "groups", "cache",
                                  "cache_off", "reverse", "nothing"])
def test_gate_block_plain_matches_jax_gate_class_block(case):
    """Fresh pairs (rows, cols, in class order and row-major within a
    class), class counts and the win matrix after the cache fold equal
    JAX's; the wrapper takes the plain version for CPU tensors, with no
    launch counted."""
    x = _gate_inputs(case)
    w_ref, rows_ref, cols_ref, counts_ref = _jax_gate(x)
    args = _port_args(x)
    rows, cols, counts, n_class = kernels.gate_block_plain(*args)
    np.testing.assert_array_equal(rows.numpy(), rows_ref)
    np.testing.assert_array_equal(cols.numpy(), cols_ref)
    np.testing.assert_array_equal(counts.numpy(), counts_ref)
    assert counts.dtype == torch.int32 and n_class == tuple(counts_ref)
    np.testing.assert_array_equal(args[13].numpy(), w_ref)
    if case == "nothing":
        assert len(rows_ref) == 0
    else:
        assert len(rows_ref) > 0
    if case in ("cache", "reverse"):
        assert (w_ref != x["w"]).any()      # the fold changed w
    if case == "block":
        assert (counts_ref > 0).sum() >= 2  # more than one class
    before = kernels.gate_block.launches
    args = _port_args(x)
    got = kernels.gate_block(*args)
    assert kernels.gate_block.launches == before
    np.testing.assert_array_equal(got[0].numpy(), rows_ref)
    np.testing.assert_array_equal(args[13].numpy(), w_ref)


def test_gate_block_rejects_bad_inputs():
    x = _gate_inputs("block")
    args = _port_args(x)
    bad = list(args)
    bad[2] = bad[2].long()                  # order must be int32
    with pytest.raises(ValueError, match="order_rows"):
        kernels.gate_block(*bad)
    bad = list(args)
    bad[16] = torch.arange(4, dtype=torch.int32)    # five classes
    with pytest.raises(ValueError, match="classes"):
        kernels.gate_block(*bad)
    bad = list(args)
    bad[9] = torch.zeros(10, dtype=torch.uint8)     # cache too small
    with pytest.raises(ValueError, match="cache"):
        kernels.gate_block(*bad)


def test_tier_partition_matches_jax():
    """The port's tier_partition against JAX's: the (class, tier, count)
    order of the pairs whose tier is not 0, and the [classes, tiers + 1]
    count matrix."""
    rng = np.random.default_rng(21)
    n_cls, m_caps, k = len(BOUNDS) + 1, (128, 512, 2048), 13
    a, c, n = 40, 50, 700
    flat = np.sort(rng.permutation(a * c)[:n])
    rows, cols = flat // c, flat % c
    row_ids = rng.permutation(N_READS)[:a]
    col_ids = rng.permutation(N_READS)[:c]
    nk = rng.integers(200, 6000, N_READS).astype(np.int32)
    lens = (nk + k).astype(np.int32)
    pair_nk = np.maximum(nk[row_ids[rows]], nk[col_ids[cols]])
    cls = (pair_nk[:, None] > BOUNDS[None, :]).sum(1)
    by_cls = np.argsort(cls, kind="stable")     # the gate's order
    rows, cols, cls = rows[by_cls], cols[by_cls], cls[by_cls]
    cnt = rng.choice(np.concatenate([np.arange(0, 40), np.arange(120, 140),
                                     np.arange(500, 530),
                                     np.arange(2040, 2060), [3000, 5000]]),
                     n).astype(np.int32)
    sc_tab = gates.min_numerator_table(int(lens.max()), 0.2)
    budget, pad = 1024, jbulk.CH_PAD
    rc_flat = np.full(budget + pad, -1, np.int32)
    rc_flat[:n] = rows * c + cols
    cnt_flat = np.zeros(budget + pad, np.int32)
    cnt_flat[:n] = cnt
    score_rc, counts_ref = jbulk.tier_partition(
        jnp.asarray(rc_flat), jnp.asarray(cnt_flat), jnp.int32(c),
        jnp.asarray(row_ids.astype(np.int32)),
        jnp.asarray(col_ids.astype(np.int32)), jnp.asarray(nk),
        jnp.asarray(lens), jnp.asarray(sc_tab), jnp.asarray(BOUNDS),
        budget=budget, n_classes=n_cls, m_caps=m_caps, kmer_size=k)
    score_rc = np.asarray(score_rc)[:n]
    t = torch.from_numpy
    lens_min = np.minimum(lens[row_ids[rows]], lens[col_ids[cols]])
    order, counts = bulk.tier_partition(
        t(cnt), t(cls.astype(np.int64)), t(lens_min), t(sc_tab), m_caps, k,
        n_cls)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_ref))
    assert counts.dtype == torch.int32
    order = order.numpy()
    got = (rows * c + cols)[order]
    keep = score_rc >= 0
    np.testing.assert_array_equal(got[keep], score_rc[keep])
    # the slots JAX drops are exactly the tier-0 ones (decided or rejected)
    assert (~keep).sum() == np.asarray(counts_ref)[:, 0].sum()
    assert keep.sum() > 0 and (np.asarray(counts_ref)[:, 1:] > 0).sum() >= 3


def _families(seed, n_fam=6, per=(8, 12), lo=200, hi=380, err=0.1):
    rng = np.random.default_rng(seed)
    seqs = []
    for _ in range(n_fam):
        ref = make_read(rng, int(rng.integers(lo, hi)))
        for _ in range(int(rng.integers(*per))):
            seqs.append(mutate(rng, ref, err))
    seqs.sort(key=lambda s: -len(s))
    return seqs


@pytest.mark.parametrize("case", ["rna", "cdna", "all_borderline",
                                  "overflow_tier"])
def test_engine_host_reads_keep_the_rule(case):
    """At least ORACLE_CUTOVER reads, blocks of 16 (so sweeps run): every
    wave reads the card at most twice a strand and once more at its end;
    the rare paths (forced here as in test_torch_engine.py's rare-path
    tests) read only apart, and the clusters are the oracle's."""
    seqs = _families(31 if case != "overflow_tier" else 32,
                     err=0.04 if case == "overflow_tier" else 0.1)
    assert len(seqs) >= bulk.ORACLE_CUTOVER
    params = ClusterParams(is_rna=case != "cdna")
    st0 = dict(metrics.GLOBAL.stages)
    eng = BulkClusterEngine(seqs, params, device="cpu")
    eng.k_block = 16
    if case == "all_borderline":
        eng.var_band = np.float32(1e12)
    if case == "overflow_tier":
        eng.m_ladder = (eng.m_ladder[0],)
    got = eng.cluster()
    strands = 1 if params.is_rna else 2
    assert eng.waves > 0
    assert eng.wave_reads_max <= 1 + 2 * strands
    assert eng.host_reads <= eng.waves * (1 + 2 * strands)
    if case in ("all_borderline", "overflow_tier"):
        assert eng.n_oracle_fallbacks > 0 and eng.rare_reads > 0
    want = oracle.cluster_reads(seqs, params)
    assert [(c_.main_seq.seq_id, c_.main_seq.rev,
             [(s.seq_id, s.rev) for s in c_.seqs]) for c_ in got] == \
        [(c_.main_seq.seq_id, c_.main_seq.rev,
          [(s.seq_id, s.rev) for s in c_.seqs]) for c_ in want]
    # on the CPU no section has a device time
    job = {k for k, v in metrics.GLOBAL.stages.items() if v != st0.get(k)}
    assert "cluster.wave" in job
    assert not any(k.endswith("_dev") for k in job)


# --------------------------------------------------------------------------
# the card's launch plans and count layout, checked here in Python
# --------------------------------------------------------------------------

# phase 2b's shapes (block, first sweep tile, 1,024 x every read, ragged),
# the sweep tile of every wave above 65,536 reads, and empty sides
PLAN_SHAPES = [(4096, 4096), (286, 4096), (1024, 8192), (1000, 777),
               (1, 129), (129, 15), (15, 1), (333, 4097), (4096, 65536),
               (0, 5), (7, 0)]


@pytest.mark.parametrize("n_sm", [132, 1])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_gate_block_plan_covers_every_tile_once(shape, n_sm):
    """Every 128 x 128 output tile is computed by exactly one CTA; no more
    CTAs than fit on the card or than there are tiles, and none idle."""
    a, c = shape
    plan = kernels.gate_block_plan(a, c, n_sm)
    tiles_r, tiles_c = -(-a // 128), -(-c // 128)
    assert plan["tiles"] == tiles_r * tiles_c
    assert plan["ctas"] == min(n_sm * kernels.GATE_CTAS_PER_SM, plan["tiles"])
    seen = {}
    for cta, walk in enumerate(kernels.gate_block_walk(plan)):
        assert walk and len(walk) <= plan["tiles_per_cta"]
        for tr, tc in walk:
            assert 0 <= tr < tiles_r and 0 <= tc < tiles_c
            seen[(tr, tc)] = seen.get((tr, tc), 0) + 1
    assert len(seen) == plan["tiles"] and set(seen.values()) <= {1}
    if plan["tiles"]:
        # a CTA walks its tiles row tile fastest
        first = kernels.gate_block_walk(plan)[0]
        assert first == sorted(first, key=lambda rc: (rc[1], rc[0]))


def _tile_orders(order_rows, order_cols):
    """(row_min, col_max): each 128-row tile's least row order and each
    128-column tile's largest column order, past the edge INT32_MAX /
    INT32_MIN, as csrc/gate_block.cu's gate_sides_kernel writes them."""
    def tiles(order, pad):
        out = np.full(-(-len(order) // 128) * 128, pad, np.int64)
        out[:len(order)] = order
        return out.reshape(-1, 128)
    i32 = np.iinfo(np.int32)
    return (tiles(order_rows, i32.max).min(1),
            tiles(order_cols, i32.min).max(1))


# (A, C, orders): a block wave (positions), a block of shuffled positions,
# a sweep tile (rows 0, columns 1), ragged blocks
WALK_CASES = [(4096, 4096, "block"), (4096, 4096, "shuffled"),
              (286, 4096, "sweep"), (1000, 777, "block"),
              (333, 4097, "shuffled"), (129, 15, "block"), (1, 1, "block"),
              (300, 300, "block")]


@pytest.mark.parametrize("n_sm", [132, 1])
@pytest.mark.parametrize("case", WALK_CASES)
def test_gate_block_walk_deals_the_tiles_left_once(case, n_sm):
    """Pass 1's dealing with the tile skip, as gate_block_walk models it:
    every tile holding a pair that may pass the order test (order_row <
    order_col) is computed exactly once; a tile skipped holds no such pair;
    a CTA takes at most tiles_per_cta tiles, so at most GATE_MAX_WALK where
    the plan is supported (the kernel lists every CTA's tiles)."""
    a, c, kind = case
    rng = np.random.default_rng(a + c)
    if kind == "sweep":
        o_r, o_c = np.zeros(a, np.int64), np.ones(c, np.int64)
    else:
        pos = np.arange(max(a, c))
        if kind == "shuffled":
            pos = rng.permutation(pos)
        o_r, o_c = pos[:a], pos[:c]
    row_min, col_max = _tile_orders(o_r, o_c)
    plan = kernels.gate_block_plan(a, c, n_sm)
    walk = kernels.gate_block_walk(plan, row_min, col_max)
    seen = {}
    for tiles in walk:
        assert len(tiles) <= plan["tiles_per_cta"]
        if plan["supported"]:
            assert len(tiles) <= kernels.GATE_MAX_WALK
        for tr, tc in tiles:
            seen[(tr, tc)] = seen.get((tr, tc), 0) + 1
    assert set(seen.values()) <= {1}
    for tr in range(plan["tiles_r"]):
        for tc in range(plan["tiles_c"]):
            rs = o_r[tr * 128:(tr + 1) * 128]
            cs = o_c[tc * 128:(tc + 1) * 128]
            may = bool((rs[:, None] < cs[None, :]).any())
            assert ((tr, tc) in seen) == may, (tr, tc)
    if kind == "block" and plan["tiles_r"] > 1:
        # a block wave's lower triangle is skipped
        assert len(seen) == plan["tiles_r"] * (plan["tiles_r"] + 1) // 2 \
            if a == c else len(seen) < plan["tiles"]


@pytest.mark.parametrize("shape,n_sm,ok", [
    ((4096, 4096), 132, True), ((286, 4096), 132, True),
    ((4096, 65536), 132, True), ((1024, 8192), 132, True),
    ((4096, 4096), 1, False), ((4096, 65536), 1, False),
    ((41000, 41000), 132, False), ((128, 131072), 132, False)])
def test_gate_block_plan_supported_at_the_engine_shapes(shape, n_sm, ok):
    """The kernel takes every shape the engine gives it on the H100's 132
    SMs (a block of k_block <= 4,096 reads, a sweep tile of k_block x
    SWEEP_TILE); the wrapper refuses a plan with more than
    GATE_MAX_SIDE_TILES row and column tiles or more than GATE_MAX_WALK
    tiles a CTA instead of running it another way."""
    plan = kernels.gate_block_plan(*shape, n_sm)
    assert plan["supported"] is ok


@pytest.mark.parametrize("n_sm", [132, 1])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_absorb_rest_plan_covers_every_entry_once(shape, n_sm):
    """The (panel, strip) CTAs read every entry of the S x C win matrix
    exactly once; above ABSORB_ONE_STRIP rows, panels with at least
    ABSORB_MIN_ROWS rows a strip where S allows, aiming at two CTAs an SM;
    at most that, the column layout, all rows a CTA."""
    s, c = shape
    plan = kernels.absorb_rest_plan(s, c, n_sm)
    cells = kernels.absorb_rest_cells(plan, s, c)
    assert len(cells) == plan["ctas"] == plan["panels"] * plan["strips"]
    assert 1 <= plan["strips"] < 65536
    assert plan["strips"] * plan["rows_per_strip"] >= s
    if c == 0:                              # the wrapper launches nothing
        assert plan["ctas"] == 0
        return
    rows = np.zeros(s + 1, np.int64)
    cols = np.zeros(c + 1, np.int64)
    for r0, r1, c0, c1 in cells:
        assert 0 <= r0 <= r1 <= s and 0 <= c0 <= c1 <= c
        if c0 == 0:
            rows[r0:r1] += 1
        if r0 == 0:
            cols[c0:c1] += 1
    assert (rows[:s] == 1).all() and (cols[:c] == 1).all()
    if s <= kernels.ABSORB_ONE_STRIP:
        assert plan["strips"] == 1 and plan["layout"] == "columns"
    else:
        assert plan["layout"] == "panels"
        if s >= kernels.ABSORB_MIN_ROWS * plan["strips"]:
            assert plan["rows_per_strip"] >= kernels.ABSORB_MIN_ROWS
    if s >= 2048 and c > 0:
        assert plan["ctas"] >= kernels.ABSORB_CTAS_PER_SM * n_sm


EMIT_WARPS = 8          # csrc/gate_block.cu kEmitWarps: segments a row


def _gate_numpy(args):
    """The gate of ``args`` in numpy, as the card lays it out.  Pass 1: each
    fresh pair counted by (class, row), a pair's class the larger of its
    two reads' own classes, the columns' classes kept as two bit planes a
    32-column word; the counts scanned class-major into offsets.  Pass 2,
    for each row with a fresh pair: its mask words cut into EMIT_WARPS
    segments of a multiple of 32 words, each segment's pairs counted by
    class and the counts scanned
    from the row's offsets, then each segment walked in column order with a
    running offset a class.  Returns (rows, cols, class counts, counts by
    (class, row))."""
    x = [t.numpy() if isinstance(t, torch.Tensor) else t for t in args]
    (bvp_r, bvc_r, ord_r, grp_r, bvp_c, bvc_c, ord_c, grp_c, tab, cache,
     cache_n, rid, cid, _w, _sv, nk, bounds) = x

    def planes(words):
        bits = (words.view(np.uint32)[:, :, None] >> np.arange(32)) & 1
        return bits.reshape(len(words), -1).astype(np.int32)

    common = planes(bvp_r) @ planes(bvp_c).T
    fresh = (common >= tab[np.maximum(bvc_r[:, None], bvc_c[None, :])]) \
        & (ord_r[:, None] < ord_c[None, :]) & (grp_r[:, None] == grp_c[None])
    if cache is not None:
        fresh &= cache[rid[:, None] * cache_n + cid[None, :]] == 0
    n_cls = len(bounds) + 1
    a, c = fresh.shape
    n_words = -(-c // 32)
    r_cls = (nk[rid][:, None] > bounds).sum(1)
    c_cls = np.zeros(n_words * 32, np.int64)
    c_cls[:c] = (nk[cid][:, None] > bounds).sum(1)
    lo = (c_cls & 1).reshape(n_words, 32)       # the two planes
    hi = (c_cls >> 1).reshape(n_words, 32)
    cls = np.maximum(r_cls[:, None], c_cls[None, :c])
    counts = np.stack([(fresh & (cls == k)).sum(1) for k in range(n_cls)])
    flat = counts.ravel()
    offsets = (np.cumsum(flat) - flat).reshape(n_cls, a)
    total = int(flat.sum())
    rows = np.full(total, -1, np.int64)
    cols = np.full(total, -1, np.int64)
    padded = np.zeros((a, n_words * 32), bool)
    padded[:, :c] = fresh
    words = padded.reshape(a, n_words, 32)
    seg = -(-n_words // (EMIT_WARPS * 32)) * 32
    for r in range(a):
        if counts[:, r].sum() == 0:
            continue                        # exits after one load
        segs = [range(min(n_words, w * seg), min(n_words, (w + 1) * seg))
                for w in range(EMIT_WARPS)]

        def pair_cls(m):
            return np.maximum(r_cls[r], lo[m] | (hi[m] << 1))

        seg_counts = np.array([[sum(int((words[r, m] & (pair_cls(m) == k))
                                        .sum()) for m in sg)
                                for k in range(n_cls)] for sg in segs])
        starts = offsets[:, r] + np.cumsum(seg_counts, 0) - seg_counts
        for sg, run in zip(segs, starts):
            run = run.copy()
            for m in sg:
                for lane in np.nonzero(words[r, m])[0]:
                    k = pair_cls(m)[lane]
                    rows[run[k]], cols[run[k]] = r, 32 * m + lane
                    run[k] += 1
    return rows, cols, counts.sum(1), counts


@pytest.mark.parametrize("case", ["cache", "cache_off", "iso", "sweep",
                                  "wide"])
@pytest.mark.parametrize("n_cls", [1, 2, 3, 4])
def test_gate_count_layout_reproduces_plain_order(case, n_cls):
    """The card's layout (counts by (class, row), exclusive scan, pass 2's
    walk of each row's mask words in segments, classes from the column
    planes) gives gate_block_plain's rows and cols element for element on
    the engine's reads, with a row that has no fresh pair among them."""
    from rattle_tpu_torch.pipeline.profile_gate import gate_args
    seqs = _families(41)
    eng = BulkClusterEngine(seqs, ClusterParams(is_rna=True), device="cpu")
    n = eng.n
    rng = np.random.default_rng(n_cls)
    groups = None
    if case == "iso":
        groups = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32))
    if case in ("sweep", "wide"):
        # wide: the columns repeated to 2,500 (79 mask words, 3 segments)
        cols = np.arange(12, n) if case == "sweep" \
            else np.resize(np.arange(12, n), 2500)
        args = gate_args(eng, np.arange(12), cols, False, w_density=0.05,
                         seed=n_cls)
    else:
        ids = rng.permutation(n)[:40]
        args = gate_args(eng, ids, ids, True, groups=groups,
                         cache=None if case == "cache_off" else "mix",
                         w_density=0.05, seed=n_cls)
    # bounds at quantiles of nk, so that every class holds pairs
    q = np.quantile(eng.nk_host[:n], [0.4, 0.6, 0.8][:n_cls - 1])
    args[16] = torch.from_numpy(q.astype(np.int32))
    rows, cols, cc, counts = _gate_numpy(args)
    got = kernels.gate_block_plain(*args)
    np.testing.assert_array_equal(got[0].numpy(), rows)
    np.testing.assert_array_equal(got[1].numpy(), cols)
    np.testing.assert_array_equal(got[2].numpy(), cc)
    assert len(rows) > 0 and (counts.sum(0) == 0).any()
    if n_cls > 1 and case not in ("sweep", "wide"):
        assert (cc > 0).sum() >= 2


def _absorb_cases(s, c, plan):
    """Win matrices of S x C whose only wins lie in the last strip of the
    plan, in no row, at row 0, or spread with a column won in two strips."""
    rng = np.random.default_rng(s + c)
    last = (plan["strips"] - 1) * plan["rows_per_strip"]
    out = {}
    w = np.zeros((s, c), np.int8)
    rr = rng.integers(last, s, c)
    keep = rng.random(c) < 0.5
    w[rr[keep], np.nonzero(keep)[0]] = rng.integers(1, 3, keep.sum())
    out["last_strip"] = w
    out["none"] = np.zeros((s, c), np.int8)
    w = np.zeros((s, c), np.int8)
    w[0] = rng.integers(0, 3, c)
    out["row0"] = w
    w = rng.choice(np.array([0, 1, 2], np.int8), (s, c), p=[0.98, 0.01, 0.01])
    w[-1] = 1
    out["spread"] = w
    return out


@pytest.mark.parametrize("shape", [(286, 700), (1001, 37), (2050, 513),
                                   (4097, 16)])
def test_absorb_rest_plain_matches_jax(shape):
    """absorb_rest_plain against JAX's absorb_rest (first winning row, its
    direction, -1 for none) on matrices shaped by the card's plan: S not a
    multiple of the strips, wins only in the last strip, none, at row 0."""
    s, c = shape
    plan = kernels.absorb_rest_plan(s, c, 132)
    # one strip up to ABSORB_ONE_STRIP rows; above it S is no multiple
    assert plan["strips"] > 1 and s % plan["strips"] != 0 \
        or s <= kernels.ABSORB_ONE_STRIP
    for what, w in _absorb_cases(s, c, plan).items():
        want = np.asarray(jbulk.absorb_rest(jnp.asarray(w)))
        got = kernels.absorb_rest_plain(torch.from_numpy(w)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=what)
        got = kernels.absorb_rest(torch.from_numpy(w)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=what)
