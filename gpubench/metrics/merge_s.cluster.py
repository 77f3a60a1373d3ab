"""merge_s.cluster: the engine's merge rounds (``phase_times["merge"]``,
``cluster.merge`` of utils.metrics.GLOBAL), seconds a job."""


def read(run):
    jobs = [j for j in run["jobs"] if "cluster.merge" in j["stages"]]
    if run["mode"] != "cluster" or not jobs:
        return None
    return sum(j["stages"]["cluster.merge"] for j in jobs) / len(jobs)
