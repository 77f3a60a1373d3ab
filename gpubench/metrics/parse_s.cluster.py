"""parse_s.cluster: the program's ``cluster.parse`` span (reading, filtering
and sorting the reads, ``pipeline/stages.py::load_cluster_inputs``),
seconds a job; None where the program has no such span."""


def read(run):
    jobs = [j for j in run["jobs"] if "cluster.parse" in j["stages"]]
    if run["mode"] != "cluster" or not jobs:
        return None
    return sum(j["stages"]["cluster.parse"] for j in jobs) / len(jobs)
