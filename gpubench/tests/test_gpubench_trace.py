import pytest

from gpubench import harness, trace


def test_union_idle_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert trace.union(iv) == [(0.0, 2.0), (3.0, 4.0)]
    assert trace.covered(iv) == pytest.approx(3.0)
    assert trace.idle_share(3.0, 10.0) == pytest.approx(0.7)
    assert trace.gaps((0.0, 5.0), trace.union(iv)) == [(2.0, 3.0), (4.0, 5.0)]
    spans = [("engine", 0.0, 5.0), ("wave", 1.5, 3.0)]
    by = trace.gaps_by_span((0.0, 5.0), trace.union(iv), spans, "cli")
    assert by == {"wave": pytest.approx(1.0), "engine": pytest.approx(1.0)}
    assert trace.gaps_by_span((0.0, 6.0), [(0.0, 5.0)], [], "cli") == \
        {"cli": pytest.approx(1.0)}


def test_percentile_nearest_rank():
    v = [float(x) for x in range(1, 21)]
    assert trace.percentile(v, 90) == 18.0
    assert trace.percentile(v[::-1], 50) == 10.0
    assert trace.percentile([3.0], 90) == 3.0


def _run():
    jobs = [dict(wall_s=w, work=100, launches={"join_expand": 3, "gate_block": 2},
                 stages={"cluster.greedy": 0.1, "cluster.merge": 0.2,
                         "cluster.gate_dev": 0.001, "cluster.score_dev": 0.002})
            for w in (0.5, 0.6, 0.7, 0.8)]
    traced = [dict(window=(10.0, 11.0), spans=[],
                   device=[("void join_expand_kernel<64>(long)", 10.1, 10.2),
                           ("gate_tile_kernel(Gate)", 10.15, 10.25),
                           ("Memcpy DtoH (Device -> Pageable)", 10.5, 10.6)])]
    return dict(mode="cluster", setup_s=9.0, span_s=2.6, work=400, jobs=jobs,
                traced=traced)


@pytest.mark.parametrize("name,want", [
    ("setup_s", 9.0),
    ("cluster_reads_per_s", 400 / 2.6),
    ("host_io_s.cluster", 0.65 - 0.3),
    ("job_s_p90.cluster", 0.8),
    ("merge_s.cluster", 0.2),
    ("wave_dev_ms.cluster", 3.0),
    ("launches.cluster", 5.0),
    ("join_expand_ms", 100.0),
    ("gate_block_ms", 100.0),
    ("idle_share.cluster", 75.0),
    ("job_device_ms.cdna", 250.0),
    ("cluster_reads_per_s.cdna", 400 / 2.6),
    ("join_expand_ms.cdna", 100.0),
    ("gate_block_ms.cdna", 100.0),
    ("wave_dev_ms.cdna", 3.0),
    ("launches.cdna", 5.0),
])
def test_metric_readers(name, want):
    assert harness.reader(name)(_run()) == pytest.approx(want)


def test_readers_find_nothing_off_the_card():
    run = _run()
    run["traced"] = []
    for j in run["jobs"]:
        j["launches"] = {}
        j["stages"] = {"cluster.greedy": 0.1, "cluster.merge": 0.2}
    for name in ("wave_dev_ms.cluster", "launches.cluster", "join_expand_ms",
                 "gate_block_ms", "idle_share.cluster", "job_device_ms.cdna",
                 "wave_dev_ms.cdna", "launches.cdna", "join_expand_ms.cdna",
                 "gate_block_ms.cdna"):
        assert harness.reader(name)(run) is None


def test_breakdown_names_kernels_and_gaps():
    bd = harness.breakdown(_run()["traced"])
    names = [k for k, _v in bd["device_ops"]]
    assert names[0] in ("join_expand_kernel", "gate_tile_kernel")
    assert bd["idle_gaps"] == [["cli", pytest.approx(0.75)]]


def test_device_ms_is_none_outside_its_mode():
    run = _run()
    run["mode"] = "correct"
    assert harness.reader("job_device_ms.cdna")(run) is None
    assert harness.reader("cluster_reads_per_s.cdna")(run) is None
