"""write_s.cluster: the program's ``cluster.write`` span (the CLI's write of
``clusters.out``), seconds a job; None where the program has no such
span."""


def read(run):
    jobs = [j for j in run["jobs"] if "cluster.write" in j["stages"]]
    if run["mode"] != "cluster" or not jobs:
        return None
    return sum(j["stages"]["cluster.write"] for j in jobs) / len(jobs)
