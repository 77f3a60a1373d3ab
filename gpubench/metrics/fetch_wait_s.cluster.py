"""fetch_wait_s.cluster: the program's ``cluster.fetch`` span (the waves'
copies to the host, which wait for the device work queued before them),
seconds a job; None where the program has no such span."""


def read(run):
    jobs = [j for j in run["jobs"] if "cluster.fetch" in j["stages"]]
    if run["mode"] != "cluster" or not jobs:
        return None
    return sum(j["stages"]["cluster.fetch"] for j in jobs) / len(jobs)
