"""wave_dev_ms.cluster: the device time of the decision waves' sections (the
engine's ``*_dev`` phase times, CUDA events at the section boundaries), ms
a job."""


def read(run):
    if run["mode"] != "cluster" or not run["jobs"]:
        return None
    per = [sum(v for k, v in j["stages"].items() if k.endswith("_dev"))
           for j in run["jobs"]]
    if not any(per):
        return None
    return 1e3 * sum(per) / len(per)
