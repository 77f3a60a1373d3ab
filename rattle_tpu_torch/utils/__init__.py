# Copied from rattle_tpu/utils/__init__.py.
from .phred import phred_err, phred_symbol
from .varmath import mean, var

__all__ = ["phred_err", "phred_symbol", "mean", "var"]
