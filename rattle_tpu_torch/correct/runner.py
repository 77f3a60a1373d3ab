"""Pack runner of the correct stage: many packs' MSAs through the device
pack engine (correct/pack_engine.py), and the host aligner for packs over
the engine's capacity.

Port of the production half of rattle_tpu/correct/tpu_runner.py (its
lockstep runner is not ported).  A runner is bound to one device:
``make_pack_runner(device)`` returns the ``pack_runner`` hook of
``driver.correct_reads`` with its ``batch_msa`` attribute.
"""

from __future__ import annotations

from typing import List, Tuple

from ..config import CorrectParams
from ..io.fastx import Read, sort_read_set
from ..ops import poa
from .consensus import (correct_read_pack, fix_msa_ends,
                        generate_consensus_vector)
from .pack_engine import PackEngine


class _LaneState:
    """One pack's graph on the host; the native C++ graph when the library
    is available, the Python one otherwise."""

    def __init__(self, seqs: List[str]):
        from .. import native
        self.native = native.available()
        self.graph = native.NativePoaGraph() if self.native else poa.POAGraph()
        self.seqs = seqs

    def add_alignment(self, aln, seq: str) -> None:
        if self.native:
            self.graph.add_alignment(aln, seq)
        else:
            poa.add_alignment(self.graph, aln, seq)

    def align_fallback(self, seq: str, params: poa.POAParams):
        if self.native:
            if self.graph.n_nodes() == 0:
                return []
            return self.graph.align_local(seq, params)
        return poa.align_local(self.graph, seq, params)

    def msa(self) -> List[str]:
        return self.graph.msa()


# the engine's statistics after the last batched_msa call: packs and bases
# counted where they actually ran, fb_* the fallbacks by cause, read steps
# and the engine's section times (pack_engine.PackEngine.stats)
LAST_STATS = {"device_packs": 0, "fallback_packs": 0,
              "device_bases": 0, "host_bases": 0, "steps": 0,
              "fb_length": 0, "fb_reads": 0, "fb_node_cap": 0,
              "fb_pred_cap": 0, "fb_group_cap": 0}


def _host_msa(seqs: List[str], params: poa.POAParams) -> List[str]:
    st = _LaneState(seqs)
    for s in seqs:
        st.add_alignment(st.align_fallback(s, params), s)
    return st.msa()


def batched_msa(all_seqs: List[List[str]], params: poa.POAParams,
                engine: PackEngine) -> List[List[str]]:
    """MSA for many packs on ``engine`` (the whole per-pack read loop runs
    on its device, one kernel launch per read step); packs over its
    capacity run on the host aligner, overlapped with the device groups."""
    results = engine.msa_many(
        all_seqs, match=params.match, mismatch=params.mismatch,
        go=params.gap_open, ge=params.gap_extend,
        host_fn=lambda seqs: _host_msa(seqs, params))
    missing = [i for i, r in enumerate(results) if r is None]
    if missing:
        raise RuntimeError(f"pack engine returned no MSA for packs {missing}")
    LAST_STATS.update(engine.stats)
    return results


def _poa_params(p: CorrectParams) -> poa.POAParams:
    return poa.POAParams(p.poa_match, p.poa_mismatch, p.poa_gap_open,
                         p.poa_gap_extend)


def make_pack_runner(device="cuda"):
    """The ``pack_runner`` hook for ``correct_reads`` on ``device``:
    two-round correction with device-batched MSAs across packs.  Its
    ``batch_msa`` attribute serves correct_reads' final-consensus pass, and
    its ``engine`` attribute is the PackEngine whose ``stats`` account the
    run."""
    engine = PackEngine(device=device)

    def pack_runner(packs, p: CorrectParams, msa_fn):
        params = _poa_params(p)
        msas = batched_msa([[r.seq for r in pk.reads] for pk in packs],
                           params, engine)
        round2_inputs: List[Tuple[List[Read], List[Read], List[Read]]] = []
        for pk, msa in zip(packs, msas):
            fix_msa_ends(pk.reads, msa)
            corrected, uncorrected, _cv = correct_read_pack(
                pk.reads, msa, p.min_occ, p.gap_occ, p.err_ratio)
            second = [Read(r.header, r.seq, r.ann, r.quality)
                      for r in corrected]
            sort_read_set(second)
            round2_inputs.append((corrected, uncorrected, second))

        msas2 = batched_msa([[r.seq for r in second]
                             for _, _, second in round2_inputs], params,
                            engine)
        outcomes = []
        for (corrected, uncorrected, second), msa2 in zip(round2_inputs,
                                                          msas2):
            fix_msa_ends(second, msa2)
            cv = generate_consensus_vector(second, msa2)
            outcomes.append((corrected, uncorrected, cv.consensus_string()))
        return outcomes

    def _batch_msa(all_seqs: List[List[str]], p: CorrectParams):
        """Device-batched MSAs for correct_reads' final-consensus pass."""
        return batched_msa(all_seqs, _poa_params(p), engine)

    pack_runner.batch_msa = _batch_msa
    pack_runner.engine = engine
    return pack_runner
