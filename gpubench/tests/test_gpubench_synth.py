import numpy as np

from gpubench import synth


def test_same_seed_same_reads_and_sets_differ():
    a = synth.synthetic_reads(300, 30, [7, 0, 0])
    assert a == synth.synthetic_reads(300, 30, [7, 0, 0])
    assert a != synth.synthetic_reads(300, 30, [7, 0, 1])
    assert a != synth.synthetic_reads(300, 30, [8, 0, 0])


def test_every_seed_gets_the_same_sizes():
    per_gene = [np.bincount([g for _n, _s, g in
                             synth.synthetic_reads(400, 40, s)], minlength=40)
                for s in ([1, 0, 0], [2, 0, 3])]
    reads, lengths = synth.gene_sizes(400, 40, 0.8, 300, 3000)
    assert (per_gene[0] == reads).all() and (per_gene[1] == reads).all()
    assert reads.sum() == 400 and (np.diff(reads) <= 0).all()
    assert lengths.min() >= 300 and lengths.max() <= 3000


def test_flat_expression_and_strands():
    reads, _ = synth.gene_sizes(8192, 4096, 0.0, 300, 3000)
    assert set(reads.tolist()) == {2}
    rc = synth.synthetic_reads(200, 10, [3, 0, 0], revcomp=0.5)
    fw = synth.synthetic_reads(200, 10, [3, 0, 0], revcomp=0.0)
    assert sum(a[1] != b[1] for a, b in zip(rc, fw)) > 0
