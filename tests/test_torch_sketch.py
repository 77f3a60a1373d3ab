"""The port's device sketch vs the JAX device sketch and the host tables:
exact table equality on the CPU."""

import numpy as np
import pytest
import torch

from rattle_tpu.ops.sketch import build_sketch_tables
from rattle_tpu.ops.sketch_device import build_device_sketch as jax_sketch
from rattle_tpu_torch.ops.sketch_device import (build_device_sketch,
                                                pack_bits, sketch_from_numpy)
from tests.conftest import make_read


def _reads(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    return [make_read(rng, int(rng.integers(lo, hi))) for _ in range(n)]


def _words(plane):
    """Unpacked [N, 4096] 0/1 plane -> [N, 128] int32 words, little-endian
    bit order (bit h at word h >> 5, bit h & 31)."""
    packed = np.packbits(np.asarray(plane, np.uint8), axis=1,
                         bitorder="little")
    return np.ascontiguousarray(packed).view("<u4").view(np.int32)


def _host_words(bvp):
    return np.asarray(bvp, np.uint32).view(np.int32)


@pytest.mark.parametrize("k,both,reads", [
    (10, False, (0, 40, 40, 300)),
    (11, True, (1, 24, 40, 300)),
    (16, True, (2, 16, 60, 200)),
])
def test_sketch_matches_jax_and_host(k, both, reads):
    seqs = _reads(*reads)
    if k == 16:
        # a real k=16 k-mer hashing to PAD_HASH (G = code 3): must sort
        # before the pad slots, with its own position
        seqs[3] = seqs[3][:50] + "G" * 20 + seqs[3][50:]
    host = build_sketch_tables(seqs, k, both, use_native=False)
    ref = jax_sketch(seqs, k, both, kmax=host.kmax)
    got = build_device_sketch(seqs, k, both, kmax=host.kmax, device="cpu")
    n = len(seqs)
    assert got.hs.dtype == torch.int64 and got.bvp.dtype == torch.int32
    assert got.bvp.shape == (ref.hbp.shape[0], 128)
    for name in ("hbp", "hs", "ps", "nk"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    # the JAX device sketch drops 6-mers starting at positions >= kmax (see
    # test_bitvector_covers_tail_past_kmax); compare it on the other rows
    ok = np.asarray(ref.lens) - 6 <= ref.kmax
    np.testing.assert_array_equal(got.bvc.numpy()[ok], np.asarray(ref.bvc)[ok])
    np.testing.assert_array_equal(got.bvp.numpy()[ok], _words(ref.plane)[ok])
    np.testing.assert_array_equal(got.bvc.numpy()[:n], host.bvc)
    np.testing.assert_array_equal(got.hs.numpy()[:n], host.hs)
    np.testing.assert_array_equal(got.ps.numpy()[:n], host.ps)
    np.testing.assert_array_equal(got.bvp.numpy()[:n], _host_words(host.bvp))
    if both:
        np.testing.assert_array_equal(got.rev_hs.numpy(),
                                      np.asarray(ref.rev_hs))
        np.testing.assert_array_equal(got.rev_ps.numpy(),
                                      np.asarray(ref.rev_ps))
        np.testing.assert_array_equal(got.rev_bvp.numpy()[ok],
                                      _words(ref.rev_plane)[ok])
        np.testing.assert_array_equal(got.rev_bvp.numpy()[:n],
                                      _host_words(host.rev_bvp))
    if k == 16:
        row = got.hs.numpy()[3]
        nk = int(got.nk[3])
        assert row[nk - 1] == 0xFFFFFFFF  # real PAD-valued hashes, last
        assert (got.ps.numpy()[3, nk:] == 0).all()


def test_bitvector_covers_tail_past_kmax():
    """The longest read's nk is exactly kmax, so its last k - 6 six-mer
    starts lie at positions >= kmax.  The port covers [0, L-6) like the
    host tables (kmer.cpp:30-37); the JAX device sketch stops at kmax
    and loses them."""
    rng = np.random.default_rng(0)
    seqs = [make_read(rng, 138)] + [make_read(rng, int(rng.integers(40, 120)))
                                    for _ in range(5)]
    host = build_sketch_tables(seqs, 10, False, use_native=False)
    got = build_device_sketch(seqs, 10, False, device="cpu")
    assert got.kmax == host.kmax == 128
    np.testing.assert_array_equal(got.bvp.numpy()[:6], _host_words(host.bvp))
    np.testing.assert_array_equal(got.bvc.numpy()[:6], host.bvc)
    ref = jax_sketch(seqs, 10, False)
    assert int(ref.bvc[0]) < int(host.bvc[0])


def test_sketch_from_numpy_carries_jax_tables():
    seqs = _reads(3, 20, 60, 250)
    ref = jax_sketch(seqs, 10, True)
    got = sketch_from_numpy(
        np.asarray(ref.hbp), np.asarray(ref.hs), np.asarray(ref.ps),
        np.asarray(ref.plane), np.asarray(ref.nk), np.asarray(ref.lens),
        np.asarray(ref.bvc), rev_hs=np.asarray(ref.rev_hs),
        rev_ps=np.asarray(ref.rev_ps), rev_plane=np.asarray(ref.rev_plane),
        kmer_size=10, device="cpu")
    assert got.n_real == len(seqs) and got.kmax == ref.kmax
    np.testing.assert_array_equal(got.hs.numpy(), np.asarray(ref.hs))
    np.testing.assert_array_equal(got.bvp.numpy(), _words(ref.plane))
    np.testing.assert_array_equal(got.rev_bvp.numpy(), _words(ref.rev_plane))
    np.testing.assert_array_equal(got.ps.numpy(), np.asarray(ref.ps))


def test_padding_rows_are_inert():
    seqs = _reads(4, 10, 40, 300)
    got = build_device_sketch(seqs, 10, False, n_pad_to=16, device="cpu")
    assert got.hbp.shape[0] == 16
    assert (got.bvp.numpy()[10:] == 0).all()
    assert (got.nk.numpy()[10:] == 0).all()
    assert (got.hs.numpy()[10:] == 0xFFFFFFFF).all()


def test_pack_bits_word_order():
    plane = torch.zeros((1, 4096), dtype=torch.uint8)
    plane[0, [0, 31, 32, 4095]] = 1
    words = pack_bits(plane).numpy()[0]
    assert words[0] == 1 - 2**31  # bits 0 and 31 of word 0
    assert words[1] == 1
    assert words[127] == -2**31
