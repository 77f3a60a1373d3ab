"""The references' plain C (``*.c`` beside this module) as shared libraries:
built with ``cc -O2`` once a source and its flags (their hash in the
library's name) into ``build/gpubench_cache/`` of the checkout, and called
through ctypes, which lets other threads run."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Callable, Dict, Sequence

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
CACHE = os.path.join(ROOT, "build", "gpubench_cache")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def load(source: str, declare: Callable[[ctypes.CDLL], None],
         flags: Sequence[str] = ()) -> ctypes.CDLL:
    """The library of ``source`` (a file name beside this module), its
    functions' types set by ``declare`` once, before any thread calls
    one (ctypes may not have them set again while a call converts its
    arguments)."""
    with _LOCK:
        if source not in _LIBS:
            path_c = os.path.join(HERE, source)
            with open(path_c, "rb") as fh:
                tag = hashlib.sha256(fh.read() + " ".join(flags).encode()
                                     ).hexdigest()[:16]
            path = os.path.join(CACHE, f"{source[:-2]}.{tag}.so")
            if not os.path.exists(path):
                os.makedirs(CACHE, exist_ok=True)
                tmp = f"{path}.{os.getpid()}.tmp"
                subprocess.run(["cc", "-O2", *flags, "-shared", "-fPIC", "-o",
                                tmp, path_c], check=True)
                os.replace(tmp, path)
            lib = ctypes.CDLL(path)
            declare(lib)
            _LIBS[source] = lib
        return _LIBS[source]
