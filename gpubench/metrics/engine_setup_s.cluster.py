"""engine_setup_s.cluster: the program's ``cluster.setup`` span (the cluster
engine's set-up: the sketch, the class tables, the score caches), seconds a
job; None where the program has no such span."""


def read(run):
    jobs = [j for j in run["jobs"] if "cluster.setup" in j["stages"]]
    if run["mode"] != "cluster" or not jobs:
        return None
    return sum(j["stages"]["cluster.setup"] for j in jobs) / len(jobs)
