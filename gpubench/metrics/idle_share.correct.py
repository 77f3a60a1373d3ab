"""idle_share.correct: % of the traced correct jobs' windows in which the
device ran nothing (``metrics_util.idle_share``)."""

from gpubench.metrics_util import idle_share


def read(run):
    return idle_share(run, "correct")
