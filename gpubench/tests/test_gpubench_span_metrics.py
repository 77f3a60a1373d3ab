"""The readers of the program's own spans on a hand-made run record: each
reads its span's mean a job, and None where the program has no such span
(as a checkout without the spans reads)."""

import pytest

from gpubench import harness

SPANS = {"cluster.parse": 0.03, "cluster.setup": 0.05,
         "cluster.greedy": 0.1, "cluster.merge": 0.2, "cluster.wave": 0.18,
         "cluster.fetch": 0.04, "cluster.write": 0.02}


def _run(stages):
    jobs = [dict(wall_s=0.5, work=100, launches={},
                 stages={k: v * f for k, v in stages.items()})
            for f in (1.0, 3.0)]
    return dict(mode="cluster", setup_s=9.0, span_s=1.0, work=200,
                jobs=jobs, traced=[])


@pytest.mark.parametrize("name,want,span", [
    ("parse_s.cluster", 0.06, "cluster.parse"),
    ("write_s.cluster", 0.04, "cluster.write"),
    ("engine_setup_s.cluster", 0.1, "cluster.setup"),
    ("engine_host_s.cluster", 0.24, "cluster.wave"),
    ("fetch_wait_s.cluster", 0.08, "cluster.fetch"),
])
def test_span_readers(name, want, span):
    read = harness.reader(name)
    assert read(_run(SPANS)) == pytest.approx(want)
    assert read(_run({k: v for k, v in SPANS.items() if k != span})) is None
    # the parent's record: the engine's phases and nothing else
    assert read(_run({k: SPANS[k] for k in ("cluster.greedy",
                                            "cluster.merge")})) is None
