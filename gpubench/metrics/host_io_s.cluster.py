"""host_io_s.cluster: a job's wall less the engine's greedy pass and merge
rounds (``cluster.greedy``, ``cluster.merge`` of utils.metrics.GLOBAL): the
CLI, parsing, sorting, writing and the engine's set-up, a mean over the
window's jobs."""


def read(run):
    jobs = [j for j in run["jobs"] if "cluster.merge" in j["stages"]]
    if run["mode"] != "cluster" or not jobs:
        return None
    return sum(j["wall_s"] - j["stages"].get("cluster.greedy", 0.0)
               - j["stages"]["cluster.merge"] for j in jobs) / len(jobs)
