# Copied from rattle_tpu/utils/checkpoint.py.
"""Intra-stage checkpoint manifests (SURVEY.md §5 checkpoint/resume).

The reference's only recovery seam is the on-disk stage boundary
(clusters.out, corrected.fq, ... — main.cpp:275,406-408): a crash mid-stage
loses the stage.  For 1M-read multi-host runs the correction stage can run
for hours, so packs are checkpointed as they complete:

* a ``manifest.json`` records stage params and the set of finished pack ids,
* each finished pack's outputs append to sidecar shard files
  (corrected/uncorrected/consensus records tagged by pack id),
* on restart, finished packs are loaded from the sidecars and only the
  remainder is recomputed; the final stage outputs are re-assembled in
  deterministic pack order, so a resumed run is byte-identical to an
  uninterrupted one.

Fsync discipline: records are appended with newline framing and the manifest
is rewritten atomically (tmp + rename) after each flush interval, so a crash
can only lose packs since the last flush — never corrupt earlier ones.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..io.fastx import Read


@dataclass
class PackResult:
    pack_id: int
    corrected: List[Read]
    uncorrected: List[Read]
    consensus: str


def _read_to_obj(r: Read) -> dict:
    return {"h": r.header, "s": r.seq, "a": r.ann, "q": r.quality}


def _obj_to_read(o: dict) -> Read:
    return Read(o["h"], o["s"], o["a"], o["q"])


class CorrectCheckpoint:
    """Pack-granular checkpoint store for the correction stage.

    Usage:
        ckpt = CorrectCheckpoint(dir, params_key)   # params_key guards reuse
        done = ckpt.load()                          # {pack_id: PackResult}
        ... for each unfinished pack: ckpt.record(result)
        ckpt.finalize()                             # removes the checkpoint
    """

    FLUSH_EVERY = 8

    def __init__(self, directory: str, params_key: str):
        self.dir = directory
        self.params_key = params_key
        self.manifest_path = os.path.join(directory, "manifest.json")
        self.records_path = os.path.join(directory, "packs.jsonl")
        self._done: Dict[int, PackResult] = {}
        self._pending = 0
        self._fh = None

    # ---------- load ----------

    def load(self) -> Dict[int, PackResult]:
        """Replay the manifest + record log; stale or mismatched checkpoints
        (different params) are discarded."""
        if not os.path.exists(self.manifest_path):
            return {}
        try:
            with open(self.manifest_path) as fh:
                manifest = json.load(fh)
        except (OSError, json.JSONDecodeError):
            return {}
        if manifest.get("params_key") != self.params_key:
            return {}
        finished = set(manifest.get("finished", []))
        out: Dict[int, PackResult] = {}
        if os.path.exists(self.records_path):
            with open(self.records_path) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        o = json.loads(line)
                    except json.JSONDecodeError:
                        break  # torn tail write: everything before it is good
                    if o["pack_id"] in finished:
                        out[o["pack_id"]] = PackResult(
                            o["pack_id"],
                            [_obj_to_read(x) for x in o["corrected"]],
                            [_obj_to_read(x) for x in o["uncorrected"]],
                            o["consensus"])
        self._done = dict(out)
        return out

    # ---------- record ----------

    def record(self, res: PackResult) -> None:
        os.makedirs(self.dir, exist_ok=True)
        if self._fh is None:
            self._fh = open(self.records_path, "a")
            # a crash can leave a torn (newline-less) tail; gluing the next
            # record onto it would also poison every record after it at
            # load() time — start on a fresh line
            if self._fh.tell() > 0:
                with open(self.records_path, "rb") as rf:
                    rf.seek(-1, os.SEEK_END)
                    if rf.read(1) != b"\n":
                        self._fh.write("\n")
        self._fh.write(json.dumps({
            "pack_id": res.pack_id,
            "corrected": [_read_to_obj(r) for r in res.corrected],
            "uncorrected": [_read_to_obj(r) for r in res.uncorrected],
            "consensus": res.consensus,
        }) + "\n")
        self._done[res.pack_id] = res
        self._pending += 1
        if self._pending >= self.FLUSH_EVERY:
            self.flush()

    def flush(self) -> None:
        if self._fh is not None:
            self._fh.flush()
            os.fsync(self._fh.fileno())
        tmp = self.manifest_path + ".tmp"
        os.makedirs(self.dir, exist_ok=True)
        with open(tmp, "w") as fh:
            json.dump({"params_key": self.params_key,
                       "finished": sorted(self._done)}, fh)
        os.replace(tmp, self.manifest_path)
        self._pending = 0

    def finalize(self) -> None:
        """Stage complete: the stage artifacts are now the checkpoint."""
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        for path in (self.manifest_path, self.records_path):
            if os.path.exists(path):
                os.remove(path)
        try:
            os.rmdir(self.dir)
        except OSError:
            pass


class ClusterCheckpoint:
    """Phase-granular checkpoint for the clustering stage.

    New capability vs the reference, whose only recovery seam is the
    finished clusters.out (main.cpp:275; SURVEY §5): a crash mid-cluster on
    a 1M-read run loses the whole stage.  Phases: the greedy seeding pass,
    then one per merge round of the B->b->0 threshold schedule
    (cluster.cpp:124-256).  After each phase the full cluster state (over
    LOCAL length-sorted indices) is written atomically in the hps wire
    format, so a resumed run replays only the remaining merge rounds and is
    byte-identical to an uninterrupted one (every phase is a deterministic
    function of its input state).
    """

    def __init__(self, directory: str, params_key: str):
        self.dir = directory
        self.params_key = params_key
        # namespace the files by params_key: the --iso mode runs the gene
        # and transcript passes through one directory, and shared fixed
        # names made them clobber each other's checkpoints
        self.manifest_path = os.path.join(
            directory, f"cluster_manifest.{params_key}.json")
        self._state_fmt = os.path.join(
            directory, "cluster_state.%s." + params_key + ".hps")

    def load(self) -> Optional[Tuple[int, list]]:
        """-> (phases_done, clusters) or None if absent/stale/mismatched."""
        if not os.path.exists(self.manifest_path):
            return None
        try:
            with open(self.manifest_path) as fh:
                manifest = json.load(fh)
            if manifest.get("params_key") != self.params_key:
                return None
            phases_done = int(manifest["phases_done"])
            state_path = self._state_fmt % int(manifest["phase_file"])
        except (OSError, json.JSONDecodeError, KeyError, TypeError,
                ValueError):
            return None
        try:
            from ..io.hpsio import read_clusters
            clusters = read_clusters(state_path)
        except (OSError, ValueError, EOFError):
            return None
        return phases_done, clusters

    def record(self, phases_done: int, clusters) -> None:
        # crash-atomic pairing: the state goes to a phase-numbered file and
        # the manifest -- replaced last -- names it, so a crash between the
        # two replaces leaves the old manifest pointing at the old state
        # (merge rounds are not idempotent, so replaying round N on round-N
        # output would silently diverge)
        os.makedirs(self.dir, exist_ok=True)
        from ..io.hpsio import write_clusters
        state_path = self._state_fmt % phases_done
        tmp = state_path + ".tmp"
        write_clusters(clusters, tmp)
        os.replace(tmp, state_path)
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({"params_key": self.params_key,
                       "phases_done": phases_done,
                       "phase_file": phases_done}, fh)
        os.replace(tmp, self.manifest_path)
        stale = self._state_fmt % (phases_done - 1)
        if os.path.exists(stale):
            os.remove(stale)

    def finalize(self) -> None:
        import glob
        # legacy fixed-name files (pre-namespacing layout) are never loaded
        # any more; clean them up too so upgraded runs don't leave orphans
        legacy = [os.path.join(self.dir, "cluster_manifest.json")] \
            + glob.glob(os.path.join(self.dir, "cluster_state.hps"))
        for path in [self.manifest_path] + glob.glob(
                self._state_fmt % "*") + legacy:
            if os.path.exists(path):
                os.remove(path)
        try:
            os.rmdir(self.dir)
        except OSError:
            pass


def params_key(**kwargs) -> str:
    """Stable digest of stage parameters for checkpoint compatibility."""
    import hashlib
    blob = json.dumps(kwargs, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]
