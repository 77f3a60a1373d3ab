"""engine_host_s.cluster: the cluster engine's self time outside its decision
waves, ``cluster.greedy`` + ``cluster.merge`` - ``cluster.wave`` of the
program's spans (on one card the waves are the phases' only child span),
seconds a job; None where the program has no ``cluster.wave`` span."""


def read(run):
    jobs = [j for j in run["jobs"] if "cluster.wave" in j["stages"]]
    if run["mode"] != "cluster" or not jobs:
        return None
    return sum(j["stages"].get("cluster.greedy", 0.0)
               + j["stages"].get("cluster.merge", 0.0)
               - j["stages"]["cluster.wave"] for j in jobs) / len(jobs)
