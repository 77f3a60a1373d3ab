"""correct_bases_per_s: the bases of all the window's correct jobs over the
window's span."""


def read(run):
    if run["mode"] != "correct":
        return None
    return run["work"] / run["span_s"]
