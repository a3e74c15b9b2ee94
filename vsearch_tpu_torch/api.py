"""Embeddable library API: the session protocol of the reference's
``vsearch_api.h`` / ``LIBRARY_API.md`` on the PyTorch/CUDA port.

Counterpart of vsearch_tpu/api.py, with the same names, protocol and
result dataclasses.  The reference exposes a C++ session API
(vsearch_api.h:60-124): a process-wide session guard
(``vsearch_session_begin/end``, vsearch.cc:156-292), caller-owned
``Database``/``Dbindex`` objects, and per-subsystem session handles
(``search_session_s`` search.cpp:184-366, ``cluster_session_s``
cluster.cpp:1618-1920, ``chimera_info_s`` chimera.cpp:2776-3095,
``derep_session_s`` derep.cpp:934-1100, ``mergepairs_single``
mergepairs.cpp, ``dust_single`` mask.cpp).

    from vsearch_tpu_torch import api
    from vsearch_tpu_torch.params import Parameters

    params = Parameters()
    params.opt_id = 0.97
    with api.session(params):                   # session_begin/end
        db = api.Database(); db.add(b"seq1", b"ACGT...")
        db.mask_and_index(params)
        with api.SearchSession(params, db) as ss:
            hits = ss.search(b"q1", b"ACGT...")

Sessions are context managers (RAII analog of alloc/init/cleanup/free);
the process-wide session lock reproduces the reference's one-session-at-
a-time model.  ``session_begin(params, device=None)`` selects the torch
device as the CLI's ``main(argv, device=...)`` does: ``cuda`` unless the
caller passes ``device="cpu"`` (or sets VSEARCH_TPU_TORCH_DEVICE=cpu),
and it raises when no card is present and the CPU was not asked for.
Heavy compute runs on that device exactly as in the CLI path: a search
or uchime_ref database of 512 or more sequences scores its candidates
with kernel K1, and a search session aligns each query with its top-1
candidate through K2 + K3.  Result objects mirror the reference result
structs field for field.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Tuple

from . import db as db_mod
from .index import KmerIndex
from .params import Masking, Parameters

API_VERSION_MAJOR = 1
API_VERSION_MINOR = 2
API_VERSION_PATCH = 0
API_VERSION = (API_VERSION_MAJOR * 1000000 + API_VERSION_MINOR * 1000
               + API_VERSION_PATCH)


def api_version() -> int:
    """MAJOR*1000000 + MINOR*1000 + PATCH (vsearch_api.h convention)."""
    return API_VERSION


def api_version_string() -> str:
    return "%d.%d.%d" % (API_VERSION_MAJOR, API_VERSION_MINOR,
                         API_VERSION_PATCH)


# ---------------------------------------------------------------------------
# Session guard (vsearch_session_begin/end, vsearch.cc:156-292)
# ---------------------------------------------------------------------------

_session_lock = threading.Lock()


class SessionError(RuntimeError):
    pass


def session_begin(params: Parameters, device: Optional[str] = None) -> None:
    """Acquire the process-wide session lock, select the torch device and
    resolve sentinel defaults.

    Mirrors vsearch_session_begin (vsearch.cc:283): try-lock semantics —
    a second begin while a session is active raises instead of blocking.
    ``device`` is "cuda" unless given ("cpu" runs the kernels' plain
    versions); without it VSEARCH_TPU_TORCH_DEVICE decides.  Without a
    card and without a request for the CPU, selection raises and the
    lock is not taken.
    """
    from .parallel import distributed
    if not _session_lock.acquire(blocking=False):
        raise SessionError(
            "vsearch session already active (missing session_end?)")
    try:
        distributed.select_device(device)
    except BaseException:
        _session_lock.release()
        raise
    params.apply_defaults_fixups()


def session_end() -> None:
    """Release the session lock (vsearch_session_end, vsearch.cc:173)."""
    try:
        _session_lock.release()
    except RuntimeError:
        raise SessionError("no active vsearch session")


class session:
    """Context manager over session_begin/session_end."""

    def __init__(self, params: Parameters,
                 device: Optional[str] = None) -> None:
        self.params = params
        self.device = device

    def __enter__(self) -> "session":
        session_begin(self.params, self.device)
        return self

    def __exit__(self, *exc) -> None:
        session_end()


# ---------------------------------------------------------------------------
# Database (caller-owned; core/db.hpp:69-214)
# ---------------------------------------------------------------------------

class Database(db_mod.Database):
    """Caller-owned sequence database with the library-protocol helpers.

    Inherits the CLI-path Database (read/add/sorts); adds the
    mask-and-index step of the session protocol (LIBRARY_API.md
    "Masking and indexing": dust_all + Dbindex.prepare/add_all)."""

    def mask_and_index(self, params: Parameters,
                       add_all: bool = True) -> KmerIndex:
        """Apply opt_dbmask and build the k-mer index.

        add_all=False gives the clustering protocol's empty index
        (dbindex.prepare without add_all_sequences)."""
        from .core import mask as mask_mod
        if params.opt_dbmask == Masking.dust:
            mask_mod.dust_all(self, params)
        elif params.opt_dbmask == Masking.soft and params.opt_hardmask:
            mask_mod.hardmask_all(self)
        index = KmerIndex(params.opt_wordlength)
        if add_all:
            index.add_all_sequences(self, params.opt_dbmask)
        self.index = index
        return index


def read_database(filename: str, params: Parameters) -> Tuple[Database, KmerIndex]:
    """UDB-aware load + mask + index (the CLI's search_prep shape)."""
    from .core.search import load_db_and_index
    db, index = load_db_and_index(params, filename)
    ldb = Database()
    ldb.__dict__.update(db.__dict__)
    ldb.index = index
    return ldb, index


# ---------------------------------------------------------------------------
# Global search (search_session_s, core/search.cpp:184-366)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SearchResult:
    """Mirror of search_result_s (vsearch_api.h / LIBRARY_API.md)."""
    target: int
    id: float
    matches: int
    mismatches: int
    gaps: int
    alignment_length: int
    query_length: int
    target_length: int
    accepted: bool
    strand: int
    cigar: str = ""


class SearchSession:
    """search_session_alloc/init/single/cleanup/free as one object.

    Queries go through SearchContext's batched interface, as the CLI's
    batches do: prepare_tasks masks them, search_tasks_begin scores them
    (K1 on a database of 512 or more) and dispatches the top-1 prefetch
    alignment (K2 + K3), and search_tasks_finish runs the walks."""

    def __init__(self, params: Parameters, db: Database,
                 index: Optional[KmerIndex] = None) -> None:
        from .core.search import SearchContext
        index = index or getattr(db, "index", None)
        if index is None:
            index = db.mask_and_index(params)
        self.db = db
        self.ctx = SearchContext.build(params, db, index=index)
        self._query_no = 0

    def __enter__(self) -> "SearchSession":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def _search_hits(self, queries: List[Tuple[bytes, bytes, int]]):
        """Joined hits of each query, the queries searched as one batch
        (numbered on from the session's running query count)."""
        from .io.fastx import SeqRecord
        recs = []
        for head, seq, size in queries:
            recs.append(SeqRecord(header=head, sequence=seq,
                                  seqno=self._query_no, abundance=size))
            self._query_no += 1
        ctx = self.ctx
        tasks = ctx.prepare_tasks(recs)
        ctx.search_tasks_finish(ctx.search_tasks_begin(tasks))
        return [ctx.join_task(task) for task in tasks]

    def _results(self, hits, query_seq: bytes,
                 max_results: Optional[int]) -> List[SearchResult]:
        out = []
        for h in hits:
            if not h.accepted:
                continue
            out.append(SearchResult(
                target=h.target, id=h.id, matches=h.matches,
                mismatches=h.mismatches,
                gaps=h.internal_gaps,
                alignment_length=h.internal_alignmentlength,
                query_length=len(query_seq),
                target_length=self.db.getsequencelen(h.target),
                accepted=True, strand=h.strand, cigar=h.nwalignment))
            if max_results is not None and len(out) >= max_results:
                break
        return out

    def search(self, query_head: bytes, query_seq: bytes,
               query_abundance: int = 1,
               max_results: Optional[int] = None) -> List[SearchResult]:
        """search_session_single: one query, ± strand per opt_strand (a
        batch of one)."""
        hits = self._search_hits([(query_head, query_seq,
                                   query_abundance)])[0]
        return self._results(hits, query_seq, max_results)

    def search_batch(self, queries: List[Tuple[bytes, bytes, int]],
                     max_results: Optional[int] = None
                     ) -> List[List[SearchResult]]:
        """search_batch (search.cpp:369-593): device-batched bulk search,
        the queries as one batch."""
        return [self._results(hits, seq, max_results)
                for (_, seq, _), hits in zip(queries,
                                             self._search_hits(queries))]


# ---------------------------------------------------------------------------
# Clustering (cluster_session_s, core/cluster.cpp:1618-1920)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ClusterResult:
    """Mirror of cluster_result_s."""
    is_centroid: bool
    cluster_id: int
    centroid_seqno: int
    centroid_label: bytes
    identity: float
    cigar: str


class ClusterSession:
    """Sequential greedy clustering over a caller-sorted Database.

    Protocol (LIBRARY_API.md "Clustering"): the DB must be pre-sorted
    (sortbylength for cluster_fast, sortbyabundance for cluster_size);
    the index starts EMPTY and centroids are added incrementally.
    assign() must be called in seqno order 0,1,2,...
    """

    def __init__(self, params: Parameters, db: Database) -> None:
        from .core.search import SearchContext
        from .core.cluster import ClusterEngine
        index = KmerIndex(params.opt_wordlength)
        ctx = SearchContext.build(params, db, index=index)
        self.engine = ClusterEngine(ctx.params, db, ctx)
        self.db = db
        self._next_seqno = 0

    def __enter__(self) -> "ClusterSession":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def assign(self, seqno: int) -> ClusterResult:
        """cluster_assign_single (cluster.cpp:1736-1856)."""
        if seqno != self._next_seqno:
            raise ValueError("cluster_assign_single must be called in "
                             "seqno order (expected %d, got %d)"
                             % (self._next_seqno, seqno))
        self._next_seqno += 1
        eng = self.engine
        results: List[ClusterResult] = []

        def on_hit(best, clusterno, si_p, si_m):
            target = best.target
            results.append(ClusterResult(
                is_centroid=False, cluster_id=clusterno,
                centroid_seqno=target,
                centroid_label=self.db.getheader(target),
                identity=best.id, cigar=best.nwalignment))

        def on_nohit(clusterno, si_p):
            results.append(ClusterResult(
                is_centroid=True, cluster_id=clusterno,
                centroid_seqno=seqno,
                centroid_label=self.db.getheader(seqno),
                identity=100.0, cigar=""))

        per_query = eng._round_complete(eng._round_dispatch([seqno]))
        from .core.cluster import find_best2
        si_p, si_m = per_query[0]
        best = find_best2(eng.params, self.db, si_p, si_m)
        info = eng.clusterinfo[seqno]
        info.seqno = seqno
        if best is not None:
            target = best.target
            on_hit(best, eng.clusterinfo[target].clusterno, si_p, si_m)
            info.clusterno = eng.clusterinfo[target].clusterno
            info.cigar = best.nwalignment
            info.strand = best.strand
        else:
            info.clusterno = eng.clusters
            info.cigar = None
            info.strand = 0
            eng.index.add_sequence(seqno, self.db, eng.params.opt_qmask)
            on_nohit(eng.clusters, si_p)
            eng.clusters += 1
        return results[0]


# ---------------------------------------------------------------------------
# Chimera detection (chimera_info_s, core/chimera.cpp:2776-3095)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ChimeraDetectResult:
    """Mirror of chimera_result_s (18-column uchimeout shape)."""
    flag: str                   # 'Y', 'N' or '?'
    score: float = 0.0
    query_label: bytes = b""
    parent_a_label: bytes = b""
    parent_b_label: bytes = b""
    closest_parent_label: bytes = b""
    id_query_model: float = 0.0
    id_query_a: float = 0.0
    id_query_b: float = 0.0
    id_a_b: float = 0.0
    id_query_top: float = 0.0
    left_yes: int = 0
    left_no: int = 0
    left_abstain: int = 0
    right_yes: int = 0
    right_no: int = 0
    right_abstain: int = 0
    divergence: float = 0.0


class ChimeraSession:
    """chimera_detect_init/single/cleanup as one object (uchime_ref
    semantics against a caller-indexed Database)."""

    def __init__(self, params: Parameters, db: Database,
                 index: Optional[KmerIndex] = None) -> None:
        from .core.search import SearchContext
        from .core.chimera import ChimeraEngine, detection_parameters
        index = index or getattr(db, "index", None)
        if index is None:
            index = db.mask_and_index(params)
        detection = detection_parameters(params)
        ctx = SearchContext.build(detection, db, index=index)
        ctx.tophits = detection.opt_maxaccepts + detection.opt_maxrejects
        self.engine = ChimeraEngine(params, detection, db, index, ctx)
        self.db = db
        self._query_no = 0

    def __enter__(self) -> "ChimeraSession":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def detect(self, query_head: bytes, query_seq: bytes,
               query_abundance: int = 1) -> ChimeraDetectResult:
        """chimera_detect_single (chimera.cpp:2904-2993)."""
        from .core.chimera import Status
        res = self.engine.process_query(query_head, query_seq,
                                        query_abundance, self._query_no)
        self._query_no += 1
        if res.status == Status.chimeric:
            flag = "Y"
        elif res.status == Status.suspicious:
            flag = "?"
        else:
            flag = "N"
        out = ChimeraDetectResult(flag=flag, query_label=query_head)
        if res.seqno_a >= 0:
            out.score = res.best_h
            out.parent_a_label = self.db.getheader(res.seqno_a)
            out.parent_b_label = self.db.getheader(res.seqno_b)
            closest = res.seqno_a if res.QA >= res.QB else res.seqno_b
            out.closest_parent_label = self.db.getheader(closest)
            out.id_query_model = res.QM
            out.id_query_a = res.QA
            out.id_query_b = res.QB
            out.id_a_b = res.AB
            out.id_query_top = res.QT
            out.left_yes = res.best_left_y
            out.left_no = res.best_left_n
            out.left_abstain = res.best_left_a
            out.right_yes = res.best_right_y
            out.right_no = res.best_right_n
            out.right_abstain = res.best_right_a
            out.divergence = res.divdiff
        return out


# ---------------------------------------------------------------------------
# Dereplication (derep_session_s, core/derep.cpp:934-1100)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DerepResult:
    """Mirror of derep_result_s."""
    header: bytes
    sequence: bytes
    abundance: int
    seqlen: int
    count: int


class DerepSession:
    """Streaming exact dedup with abundance summing (derep.cpp:253-533
    semantics: normalize upcase + U->T, first-seen header wins, results
    sorted by abundance desc then input order)."""

    def __init__(self) -> None:
        self._table = {}
        self._order: List[bytes] = []

    def __enter__(self) -> "DerepSession":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def add_sequence(self, header: bytes, sequence: bytes,
                     abundance: int = 1) -> None:
        from .utils.digest import normalize
        norm = normalize(sequence)
        ent = self._table.get(norm)
        if ent is None:
            self._table[norm] = [header, abundance, 1]
            self._order.append(norm)
        else:
            ent[1] += abundance
            ent[2] += 1

    def results(self) -> List[DerepResult]:
        """derep_get_results: sorted by abundance desc, then input order."""
        rows = []
        for i, norm in enumerate(self._order):
            header, abundance, count = self._table[norm]
            rows.append((-abundance, i, norm, header, abundance, count))
        rows.sort()
        return [DerepResult(header=h, sequence=n, abundance=a,
                            seqlen=len(n), count=c)
                for (_, _, n, h, a, c) in rows]


# ---------------------------------------------------------------------------
# Paired-end merging (mergepairs_single, core/mergepairs.cpp)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MergeResult:
    """Mirror of merge_result_s."""
    merged: bool
    merged_sequence: bytes = b""
    merged_quality: bytes = b""
    merged_length: int = 0
    ee_merged: float = 0.0
    ee_fwd: float = 0.0
    ee_rev: float = 0.0
    fwd_errors: int = 0
    rev_errors: int = 0
    overlap_length: int = 0


class MergeSession:
    """mergepairs_init + mergepairs_single; stateless per call."""

    def __init__(self, params: Parameters) -> None:
        from .core.mergepairs import QualTables
        self.params = params
        self.tables = QualTables(params)

    def __enter__(self) -> "MergeSession":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def merge(self, fwd_seq: bytes, fwd_qual: bytes,
              rev_seq: bytes, rev_qual: bytes,
              fwd_header: bytes = b"f", rev_header: bytes = b"r"
              ) -> MergeResult:
        from .core.mergepairs import MergeData, process
        pair = MergeData(
            fwd_header=fwd_header, rev_header=rev_header,
            fwd_sequence=bytearray(fwd_seq), rev_sequence=bytearray(rev_seq),
            fwd_quality=bytearray(fwd_qual), rev_quality=bytearray(rev_qual),
            fwd_length=len(fwd_seq), rev_length=len(rev_seq))
        process(pair, self.tables, self.params)
        if not pair.merged:
            return MergeResult(merged=False)
        merged_length = len(pair.merged_sequence)
        # overlap = fwd_trunc + rev_trunc - merged_length
        # (reference mergepairs_single, mergepairs.cpp:851)
        return MergeResult(
            merged=True, merged_sequence=bytes(pair.merged_sequence),
            merged_quality=bytes(pair.merged_quality),
            merged_length=merged_length,
            ee_merged=pair.ee_merged, ee_fwd=pair.ee_fwd,
            ee_rev=pair.ee_rev, fwd_errors=pair.fwd_errors,
            rev_errors=pair.rev_errors,
            overlap_length=pair.fwd_trunc + pair.rev_trunc - merged_length)


# ---------------------------------------------------------------------------
# Masking (dust_single, core/mask.cpp)
# ---------------------------------------------------------------------------

def dust_single(sequence: bytes, hardmask: bool = False) -> bytes:
    """DUST-mask one sequence (mask.cpp dust_single). Thread-safe,
    needs no session."""
    from .core.mask import dust_mask
    return dust_mask(sequence, hardmask)
