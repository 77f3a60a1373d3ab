"""launches.cluster: the kernel wrappers' launch counters
(``ops.kernels.launches()``), summed, a job."""


def read(run):
    if run["mode"] != "cluster" or not run["jobs"]:
        return None
    per = [sum(j["launches"].values()) for j in run["jobs"]]
    if not any(per):
        return None
    return sum(per) / len(per)
