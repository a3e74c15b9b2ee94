"""UCHIME-family chimera detection.

Mirrors reference src/core/chimera.cpp: query split into parts, per-part
k-mer search collecting candidate parents, full-query alignment against all
candidates (device-batched here), window-smoothed two-parent selection,
3-way column model, vote-based h-score and the uchime/uchime2/uchime3
classification rules.

Round-batched TPU-first design (the clustering engine's speculative-round
pattern, core/cluster.py): instead of the reference's one-thread-per-query
claim loop (chimera.cpp:2405-2419, :2226-2243), W queries are processed per
round against the REFERENCE SET FROZEN AT ROUND START — all part-candidate
searches as one batched top-k, all accept/reject alignment waves merged
across queries, and all full-query candidate alignments as one batch.
Queries are then resolved serially in abundance order with an EXACT repair:
non-chimeras accepted earlier in the same round are merged into each later
part's candidate heap by the reference min-heap total order (count desc,
length asc, seqno asc — minheap.cpp:111-146) and the walk is replayed with
the cached alignments, reproducing the reference's serial (--threads 1)
output byte-for-byte.

Counterpart of vsearch_tpu/core/chimera.py.  Once the de novo reference
set reaches DEVICE_MIN sequences, part-candidate scoring runs on the
device through the growing k-mer index (ops/score_grow.py, kernel K4);
uchime_ref scores on SearchContext's static index (kernel K1).  The walk
waves and the full-query batches go through SearchContext.align_pairs
(kernels K2 and K3, or K6 and K7 under a mismatch score outside int8,
above the aligner's NATIVE_CELLS_LIMIT).  A failure on the device tier
raises.
"""

from __future__ import annotations

import dataclasses
import enum
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..params import Masking, Parameters
from ..db import Database
from ..index import KmerIndex
from ..ops import kmer as kmer_ops
from ..ops.bundle import bundle_fetch, unbundle_fetch
from ..ops.nw import AlignmentResult
from ..ops.score_dense import RANK_MAX
from ..ops.score_grow import GrowingDeviceKmerIndex, growing_index_class
from ..utils.maps import CHRMAP_4BIT, CHRMAP_UPCASE, AMBIGUOUS_4BIT
from ..utils.phasetimer import phase
from .searchcore import (Hit, QueryInfo, QueryWalk, join_hits,
                         replay_onequery)
from .search import SearchContext

MAXPARTS = 100
WINDOW = 32
FEW = 4
MAXCANDIDATES = FEW * MAXPARTS
REJECTS = 16
CHIMERA_ID = 0.55

_CIGAR_RE = re.compile(r"(\d*)([MDI])")


class Status(enum.IntEnum):
    no_parents = 0
    no_alignment = 1
    low_score = 2
    suspicious = 3
    chimeric = 4


def detection_parameters(params: Parameters) -> Parameters:
    """reference: chimera.cpp chimera_detection_parameters (:2805-2824)."""
    detection = dataclasses.replace(params)
    detection.opt_maxaccepts = FEW
    detection.opt_maxrejects = REJECTS
    detection.opt_id = CHIMERA_ID
    detection.opt_weak_id = detection.opt_id
    if params.opt_uchime_ref is None:
        detection.opt_self = 1
        detection.opt_selfid = 1
        # C++ 1.0/0.0 == +inf (no abundance filtering when abskew unset)
        detection.opt_maxsizeratio = (1.0 / params.opt_abskew
                                      if params.opt_abskew else float("inf"))
    return detection


@dataclasses.dataclass
class ChimeraLongResult:
    """Result of the chimeras_denovo 'long read' evaluation
    (reference: eval_parents_long, chimera.cpp:995-1243)."""
    status: Status
    seqnos: List[int]        # parent db seqnos in query-position order
    QP: List[float]          # per-parent global similarity
    best_h: float = 0.0      # the long path never sets a score (:2017)
    QT: float = 0.0
    divfrac: float = 0.0
    qaln: bytes = b""
    palns: Tuple[bytes, ...] = ()
    diffs: bytes = b""
    model: bytes = b""


@dataclasses.dataclass
class ChimeraResult:
    status: Status
    best_h: float = 0.0
    # set when parents were evaluated
    seqno_a: int = -1
    seqno_b: int = -1
    QA: float = 0.0
    QB: float = 0.0
    AB: float = 0.0
    QT: float = 0.0
    QM: float = 0.0
    divdiff: float = 0.0
    divfrac: float = 0.0
    best_left_y: int = 0
    best_left_n: int = 0
    best_left_a: int = 0
    best_right_y: int = 0
    best_right_n: int = 0
    best_right_a: int = 0
    # alignment strings for uchimealns
    qaln: bytes = b""
    paln_a: bytes = b""     # in A-role order (after reverse flip)
    paln_b: bytes = b""
    diffs: bytes = b""
    votes: bytes = b""
    model: bytes = b""
    best_is_reverse: bool = False


class ChimeraEngine:
    # reference-set size from which de novo candidate scoring moves to the
    # growing device index (per-query device latency beats the host
    # postings cost only once the accepted set is large)
    DEVICE_MIN = 4096

    # the most positions the rank key orders (a multiple of K4's
    # 4096-position block); beyond it the host tier scores
    DEVICE_MAX = RANK_MAX & ~4095

    def __init__(self, params: Parameters, detection: Parameters,
                 db: Database, index: KmerIndex,
                 ctx: SearchContext) -> None:
        self.params = params           # original run parameters
        self.detection = detection     # detection knobs copy
        self.db = db
        self.index = index
        self.ctx = ctx                 # SearchContext built with detection
        self.tophits = detection.opt_maxaccepts + detection.opt_maxrejects
        self._dev_index = None

    def _device_capacity(self, count: int) -> int:
        """Sized once to the run's upper bound (every input could be
        accepted into the reference set): no mid-run rebuild means no
        re-upload; device zeros make over-allocation device-memory-only."""
        cap = max(2 * count, 40960, self.db.seqcount)
        return min((cap + 4095) // 4096 * 4096, self.DEVICE_MAX)

    def _part_candidates(self, kmers_list, samplecounts, minmatches_list,
                         raw=None):
        """Candidate parents for every query part, batched on device when
        an index tier is available: uchime_ref rides the static
        DeviceKmerIndex (dense MXU path) built by SearchContext; denovo
        modes use the growing scatter-append index (ops/score_grow.py)
        past DEVICE_MIN accepted sequences."""
        if self.ctx.device_index is not None:
            return self.ctx._candidates_batch(kmers_list, samplecounts)
        dev = self._growing_device()
        if dev is not None and dev.supports(kmers_list):
            return dev.topk_batch(kmers_list, self.tophits, minmatches_list)
        return self.index.candidates_for_query_batch(
            kmers_list, self.tophits, minmatches_list, raw=raw)

    def _growing_device(self):
        """Lazy device mirror of the growing denovo index, self-synced to
        the host index's current length."""
        count = self.index.count
        if count > self.DEVICE_MAX:
            self._dev_index = None
            return None
        if self._dev_index is None:
            if count < self.DEVICE_MIN:
                return None
            self._dev_index = self._build_device(count)
        elif self._dev_index.n < count:
            entries = [(self.index._kmer_lists[p],
                        self.index.lengths[p], self.index.mapping[p])
                       for p in range(self._dev_index.n, count)]
            if not self._dev_index.append_round(entries):
                # growth past the capacity sized at activation
                self._dev_index = self._build_device(count)
        return self._dev_index

    def _build_device(self, count: int) -> GrowingDeviceKmerIndex:
        # several ranks: ShardedGrowingKmerIndex
        return growing_index_class().build(
            self.index.wordlength, self.index.kmer_lists_by_position(),
            list(self.index.lengths), list(self.index.mapping),
            capacity=self._device_capacity(count),
            device=self.ctx.aligner.device)

    def parts_for(self, query_len: int) -> int:
        """reference: realloc_arrays (:275-299)."""
        params = self.params
        if params.opt_chimeras_denovo is not None:
            if params.opt_chimeras_parts == 0:
                parts = (query_len + 99) // 100
            else:
                parts = params.opt_chimeras_parts
            return min(max(parts, 2), MAXPARTS)
        return 4

    # -- round-batched pipeline -----------------------------------------

    def partition(self, query_seq: bytes) -> List[bytes]:
        """partition_query (:1957-1982)."""
        parts = self.parts_for(len(query_seq))
        if len(query_seq) < parts:
            return []
        out = []
        rest = len(query_seq)
        cursor = 0
        for i in range(parts):
            length = (rest + (parts - i - 1)) // (parts - i)
            out.append(query_seq[cursor:cursor + length])
            rest -= length
            cursor += length
        return out

    def search_round(self, queries: List[Tuple[bytes, bytes, int, int]],
                     with_tracker: bool = True
                     ) -> Tuple[List["_RoundQuery"],
                                Optional["_ExtrasTracker"]]:
        """Speculative phase for a round of (head, seq, size, seqno)
        queries against the reference set frozen at round start.

        Batches, across the whole round: part k-mer extraction (one native
        call), part-candidate top-k (one index call — static device index,
        growing device index, or host postings), the accept/reject
        alignment waves (merged lockstep), and the full-query candidate
        alignments (one batch)."""
        return self.round_finish(self.round_begin(queries), with_tracker)

    def round_begin(self, queries: List[Tuple[bytes, bytes, int, int]]
                    ) -> dict:
        """Host prep + candidate dispatch for one round.

        When the growing device tier is active the part-candidate top-k
        dispatches asynchronously (the driver's 1-round-lag pipeline
        resolves the previous round while this one's scoring runs); host
        and static-index candidates are computed synchronously HERE so
        the frozen-set snapshot matches dispatch time either way."""
        with phase("prep"):
            st = self._round_prep(queries)
        dev = None
        if self.ctx.device_index is None:
            dev = self._growing_device()
        kmers_list = st["kmers_list"]
        if dev is not None and dev.supports(kmers_list):
            with phase("dispatch"):
                _, pending = dev.topk_dispatch(kmers_list, self.tophits)
                # the device->host copies start now, so they overlap the
                # previous round's resolution
                bundled = bundle_fetch(pending, None)
            st.update(dev=dev, pending=pending, bundled=bundled)
        else:
            with phase("host_topk"):
                st["cand_lists"] = self._part_candidates(
                    kmers_list, st["sizes"], st["minmatches"],
                    raw=(st["kbuf"], st["part_off"]))
        return st

    def _round_prep(self, queries: List[Tuple[bytes, bytes, int, int]]
                    ) -> dict:
        """A round's parts and their k-mer sets (one batched extraction)."""
        detection = self.detection
        denovo = self.params.opt_uchime_ref is None
        rqs: List[_RoundQuery] = []
        part_seqs: List[bytes] = []
        part_owner: List[int] = []        # global part -> query idx in round
        for head, seq, size, qno in queries:
            rq = _RoundQuery(head=head, seq=seq, size=size, qno=qno)
            rq.parts = self.partition(seq)
            rq.part_lo = len(part_seqs)
            part_seqs.extend(rq.parts)
            part_owner.extend([len(rqs)] * len(rq.parts))
            rqs.append(rq)

        # one threaded extraction for all parts — plus, in denovo mode, the
        # full-query k-mer sets the index/repair tracker will need for the
        # queries accepted as non-chimeras.  Everything stays in the
        # concatenated (buf, offsets) wire format so the postings bulk
        # calls below are zero-copy.
        nparts_total = len(part_seqs)
        if denovo:
            kbuf, koff = kmer_ops.unique_kmer_sets_batch_raw(
                part_seqs + [rq.seq for rq in rqs],
                self.index.wordlength, detection.opt_qmask)
            for qidx, rq in enumerate(rqs):
                lo, hi = koff[nparts_total + qidx], koff[nparts_total
                                                         + qidx + 1]
                rq.full_kmers = kbuf[lo:hi]
        else:
            kbuf, koff = kmer_ops.unique_kmer_sets_batch_raw(
                part_seqs, self.index.wordlength, detection.opt_qmask)
        part_off = koff[:nparts_total + 1]
        kmers_list = [kbuf[part_off[i]:part_off[i + 1]]
                      for i in range(nparts_total)]
        mwm = detection.opt_minwordmatches
        mwm_u = mwm & 0xFFFFFFFF if mwm < 0 else mwm
        ksizes = np.diff(part_off)
        sizes = ksizes.tolist()
        minmatches = np.minimum(mwm_u, ksizes).tolist()

        return dict(rqs=rqs, part_seqs=part_seqs, part_owner=part_owner,
                    kbuf=kbuf, koff=koff, part_off=part_off,
                    kmers_list=kmers_list, sizes=sizes,
                    minmatches=minmatches, denovo=denovo,
                    nparts_total=nparts_total, pending=None, bundled=None,
                    dev=None, cand_lists=None)

    def round_finish(self, st: dict, with_tracker: bool = True
                     ) -> Tuple[List["_RoundQuery"],
                                Optional["_ExtrasTracker"]]:
        """Fetch the round's candidates, run the speculative walks and
        the full-query candidate alignment batch, build the tracker."""
        detection = self.detection
        denovo = st["denovo"]
        rqs = st["rqs"]
        part_seqs = st["part_seqs"]
        part_owner = st["part_owner"]
        kbuf, koff = st["kbuf"], st["koff"]
        part_off = st["part_off"]
        kmers_list = st["kmers_list"]
        sizes = st["sizes"]
        minmatches = st["minmatches"]
        nparts_total = st["nparts_total"]
        if st["cand_lists"] is not None:
            cand_lists = st["cand_lists"]
        else:
            pending = st["pending"]
            with phase("topk_fetch"):
                topk_h, _ = unbundle_fetch(st["bundled"])
            with phase("topk_cut"):
                cand_lists = st["dev"].topk_cut(
                    [(nq, f) for (nq, _), f in zip(pending, topk_h)],
                    minmatches)

        # per-part QueryInfo, built lazily (only walked/repaired parts)
        self._qi_cache: Dict[int, QueryInfo] = {}
        self._round_parts = (part_seqs, part_owner, sizes)
        self._round_state = (rqs, minmatches, cand_lists)

        # vectorized abundance-gate prefilter: in denovo mode the active
        # pre-alignment gates are self/selfid/maxsizeratio, and the
        # abundance gate (parents need >= abskew x the query's abundance,
        # chimera.cpp:2805-2824) rejects almost every candidate.  A part
        # whose candidates ALL fail it yields only rejected hits — no
        # alignments, no accepted parents — so its walk is skipped
        # outright.  self/selfid can only reject further, so keeping any
        # abundance-passer conservative-exactly preserves the walk set.
        walkable = None
        if denovo and cand_lists and self.db.seqcount:
            ratio = detection.opt_maxsizeratio
            flat_t = []
            flat_gp = []
            for gp, cands in enumerate(cand_lists):
                for s, _ in cands:
                    flat_t.append(s)
                    flat_gp.append(gp)
            if flat_t:
                abund = self._abund_arr()
                qs = np.fromiter(
                    (rqs[part_owner[gp]].size for gp in flat_gp),
                    dtype=np.int64, count=len(flat_gp))
                ts = abund[np.asarray(flat_t, dtype=np.int64)]
                if (qs.max(initial=0) < 2**53
                        and ts.max(initial=0) < 2**53
                        and np.isfinite(ratio) and ratio > 0.0):
                    ok = qs.astype(np.float64) <= ratio \
                        * ts.astype(np.float64)
                    walkable = set(np.asarray(flat_gp)[ok].tolist())

        # lockstep accept/reject alignment waves over every non-empty walk
        self._part_align_cache: Dict[Tuple[int, int], AlignmentResult] = {}
        cache = self._part_align_cache
        with phase("walk"):
            walks: Dict[int, QueryWalk] = {
                gp: QueryWalk(detection, self._qi(gp), self.db, cands)
                for gp, cands in enumerate(cand_lists)
                if cands and (walkable is None or gp in walkable)}
            active = [gp for gp, w in walks.items() if not w.done]
            while active:
                pair_list = []
                owners = []
                for gp in active:
                    for t in walks[gp].advance():
                        pair_list.append((part_seqs[gp], t))
                        owners.append((gp, t))
                if not pair_list:
                    break
                results = self.ctx.align_pairs(pair_list)
                per_walk: Dict[int, Dict[int, AlignmentResult]] = {}
                for (gp, t), res in zip(owners, results):
                    per_walk.setdefault(gp, {})[t] = res
                    cache[(gp, t)] = res
                nxt = []
                for gp in active:
                    if gp in per_walk:
                        walks[gp].supply(per_walk[gp])
                    if not walks[gp].done:
                        nxt.append(gp)
                active = nxt

        # per query: collect speculative candidate parents + one full-query
        # alignment batch for the whole round
        pairs = []
        owners2 = []
        for qidx, rq in enumerate(rqs):
            part_hits = [walks[rq.part_lo + lp].hits
                         if (rq.part_lo + lp) in walks else []
                         for lp in range(len(rq.parts))]
            rq.cand_list = self._collect_candidates(part_hits)
            for t in rq.cand_list:
                pairs.append((rq.seq, t))
                owners2.append(qidx)
        if pairs:
            results = self.ctx.align_pairs(pairs)
            for qidx, (pair, res) in zip(owners2, zip(pairs, results)):
                rqs[qidx].alignments[pair[1]] = res

        if not (denovo and with_tracker):
            return rqs, None
        with phase("tracker"):
            tracker = _ExtrasTracker(self.index.hashsize, kmers_list,
                                     part_owner, minmatches,
                                     [rq.full_kmers for rq in rqs],
                                     raw_parts=(kbuf, part_off),
                                     raw_full=(kbuf, koff[nparts_total:]))
        return rqs, tracker

    def _abund_arr(self) -> np.ndarray:
        """Per-seqno abundance vector (cached; the denovo db is static)."""
        arr = getattr(self, "_abund_cache", None)
        if arr is None or arr.size != self.db.seqcount:
            n = self.db.seqcount
            arr = np.fromiter((self.db.getabundance(s) for s in range(n)),
                              dtype=np.int64, count=n)
            self._abund_cache = arr
        return arr

    def _qi(self, gp: int) -> QueryInfo:
        """Per-part QueryInfo, built on first use (walk or repair)."""
        qi = self._qi_cache.get(gp)
        if qi is None:
            part_seqs, part_owner, sizes = self._round_parts
            rq = self._round_state[0][part_owner[gp]]
            pseq = part_seqs[gp]
            qi = QueryInfo(query_head=rq.head, qsequence=pseq,
                           qseqlen=len(pseq), qsize=rq.size,
                           strand=0, query_no=rq.qno)
            qi.kmersamplecount = sizes[gp]
            self._qi_cache[gp] = qi
        return qi

    def _collect_candidates(self, part_hits: List[List[Hit]]) -> List[int]:
        """Accepted per-part hits -> unique candidate parent list
        (chimera_process_query, :2018-2071)."""
        detection = self.detection
        allhits = []
        for hits in part_hits:
            for hit in join_hits(detection, hits, None):
                if hit.accepted and len(allhits) < MAXCANDIDATES:
                    allhits.append(hit)
        cand_list: List[int] = []
        for hit in allhits:
            if hit.target not in cand_list:
                cand_list.append(hit.target)
        return cand_list

    def resolve(self, rq: "_RoundQuery", qidx: int,
                tracker: Optional["_ExtrasTracker"]) -> ChimeraResult:
        """Serial resolution of one round query: repair the speculative
        result for reference sequences accepted earlier in the same round
        (exact --threads 1 replay), then evaluate parents."""
        _, minmatches, cand_lists = self._round_state
        cand_list = rq.cand_list
        if tracker is not None and rq.parts and tracker.any_pending():
            dirty = False
            merged_hits: List[Optional[List[Hit]]] = []
            for lp in range(len(rq.parts)):
                gp = rq.part_lo + lp
                extras = tracker.get(gp, qidx)
                eligible = [(s, c, ln) for (s, c, ln) in extras
                            if c >= minmatches[gp]] if extras else ()
                if not eligible:
                    merged_hits.append(None)
                    continue
                dirty = True
                merged = [(s, c, ln) for (s, c) in cand_lists[gp]
                          for ln in (self.db.getsequencelen(s),)]
                merged.extend(eligible)
                merged.sort(key=lambda e: (-e[1], e[2], e[0]))
                merged = [(s, c) for (s, c, _) in merged[:self.tophits]]
                cache = self._part_align_cache
                pseq = rq.parts[lp]

                def get_alignment(t, gp=gp, pseq=pseq):
                    res = cache.get((gp, t))
                    if res is None:
                        res = self.ctx.align_pairs([(pseq, t)])[0]
                        cache[(gp, t)] = res
                    return res

                merged_hits.append(replay_onequery(
                    self.detection, self._qi(gp), self.db, merged,
                    get_alignment))
            if dirty:
                part_hits = []
                for lp in range(len(rq.parts)):
                    if merged_hits[lp] is not None:
                        part_hits.append(merged_hits[lp])
                    else:
                        gp = rq.part_lo + lp
                        part_hits.append(
                            self._spec_hits(gp, cand_lists[gp]))
                cand_list = self._collect_candidates(part_hits)

        if not cand_list:
            return ChimeraResult(Status.no_parents)
        missing = [t for t in cand_list if t not in rq.alignments]
        if missing:
            for t, res in zip(missing, self.ctx.align_pairs(
                    [(rq.seq, t) for t in missing])):
                rq.alignments[t] = res
        return self._finish(rq.seq, cand_list,
                            [rq.alignments[t] for t in cand_list])

    def _spec_hits(self, gp: int, cands) -> List[Hit]:
        """Speculative walk hits for one part (re-derived when the round
        walk objects are gone; the alignment cache makes this host-only)."""
        if not cands:
            return []
        qi = self._qi(gp)
        cache = self._part_align_cache

        def get_alignment(t, gp=gp):
            res = cache.get((gp, t))
            if res is None:
                res = self.ctx.align_pairs([(qi.qsequence, t)])[0]
                cache[(gp, t)] = res
            return res

        return replay_onequery(self.detection, qi, self.db, cands,
                               get_alignment)

    def _finish(self, query_seq: bytes, cand_list: List[int],
                alignments: List[AlignmentResult]) -> ChimeraResult:
        """Parent selection + evaluation (chimera_process_query :2074-2170)."""
        cigars = [a.cigar for a in alignments]
        if self.params.opt_chimeras_denovo is not None:
            parents = find_best_parents_long(self.params, query_seq,
                                             cand_list, cigars, self.db)
            if parents is None:
                return ChimeraLongResult(Status.no_parents, [], [])
            return eval_parents_long(query_seq, cand_list, cigars, parents,
                                     self.db)
        best = find_best_parents(query_seq, cand_list, cigars, self.db)
        if best is None:
            return ChimeraResult(Status.no_parents)
        return eval_parents(self.params, query_seq, cand_list, cigars,
                            best, self.db)

    def process_query(self, query_head: bytes, query_seq: bytes,
                      query_size: int, query_no: int) -> ChimeraResult:
        """Single-query convenience (library chimera_detect_single path,
        chimera.cpp:2776-3095): a one-query round."""
        rqs, _ = self.search_round(
            [(query_head, query_seq, query_size, query_no)],
            with_tracker=False)
        return self.resolve(rqs[0], 0, None)


@dataclasses.dataclass
class _RoundQuery:
    """One query's speculative state within a processing round."""
    head: bytes
    seq: bytes
    size: int
    qno: int
    parts: List[bytes] = dataclasses.field(default_factory=list)
    part_lo: int = 0
    cand_list: List[int] = dataclasses.field(default_factory=list)
    alignments: Dict[int, "AlignmentResult"] = dataclasses.field(
        default_factory=dict)
    full_kmers: Optional[np.ndarray] = None   # denovo: for index growth


class _ExtrasTracker:
    """Same-round repair index: maps each accepted non-chimera (an "extra")
    to the later round parts that share k-mers with it.

    Native path: a postings index over the round's part k-mer sets probed
    once per extra (counts = |part kmers ∩ extra kmers|, exactly the
    reference's shared-unique-kmer count, searchcore.cpp:260-340).  Fallback:
    sorted-array intersection per (part, extra) on demand."""

    def __init__(self, hashsize: int, part_kmers: List[np.ndarray],
                 part_owner: List[int], part_minmatches: List[int],
                 full_kmers: List[Optional[np.ndarray]],
                 raw_parts=None, raw_full=None) -> None:
        self.part_kmers = part_kmers
        self.owner = part_owner
        self.pending: Dict[int, List[Tuple[int, int, int]]] = {}
        self.extras: List[Tuple[int, np.ndarray, int]] = []
        self.probes = None
        self._hashsize = hashsize
        self._mm = list(part_minmatches)
        self._raw_parts = raw_parts
        from .. import native
        if (native.available() and part_kmers
                and all(k is not None for k in full_kmers)):
            try:
                # probe every round query against the round's parts NOW in
                # one fused C call (shared counts don't depend on
                # acceptance); add_extra just filters its precomputed row.
                # Sub-minmatches pairs are dropped in C — they can never
                # enter a candidate heap (searchcore.cpp:320-337)
                if raw_parts is not None:
                    tbuf, toff = raw_parts
                else:
                    tbuf, toff = native._concat_kmer_lists(part_kmers)
                if raw_full is not None:
                    qbuf, qoff = raw_full
                else:
                    qbuf, qoff = native._concat_kmer_lists(
                        [k for k in full_kmers])
                res = native.cross_counts(tbuf, toff, qbuf, qoff, hashsize,
                                          part_minmatches)
                if res is not None:
                    out_t, out_c, out_off = res
                    owner_arr = np.asarray(part_owner, dtype=np.int64)
                    probes = []
                    for qi in range(len(full_kmers)):
                        lo, hi = out_off[qi], out_off[qi + 1]
                        rp = out_t[lo:hi].astype(np.int64)
                        probes.append((rp, out_c[lo:hi], owner_arr[rp]))
                    self.probes = probes
            except Exception:
                self.probes = None
        self._sorted_parts: Dict[int, np.ndarray] = {}

    def add_extra(self, seqno: int, kmers: np.ndarray, length: int,
                  qidx: int) -> None:
        """Record a non-chimera accepted by round query qidx."""
        if self.probes is not None:
            rp, rc, rown = self.probes[qidx]
            keep = rown > qidx
            for gp, c in zip(rp[keep].tolist(), rc[keep].tolist()):
                self.pending.setdefault(gp, []).append((seqno, c, length))
        else:
            self.extras.append((seqno, np.sort(kmers), length))

    def add_carry_batch(self, carries) -> None:
        """Record extras accepted in the PREVIOUS round (the driver's
        1-round-lag pipeline: this round's candidates were scored against
        the set frozen before those acceptances, so they repair through
        the exact same merge as same-round extras — which is snapshot-
        depth-invariant).  carries: [(seqno, kmers, length)]; they affect
        EVERY part of this round (no owner filter)."""
        if not carries:
            return
        if self.probes is None:
            for (s, k, ln) in carries:
                self.extras.append((s, np.sort(k), ln))
            return
        from .. import native
        try:
            if self._raw_parts is not None:
                tbuf, toff = self._raw_parts
            else:
                tbuf, toff = native._concat_kmer_lists(self.part_kmers)
            qbuf, qoff = native._concat_kmer_lists(
                [k for (_, k, _) in carries])
            res = native.cross_counts(tbuf, toff, qbuf, qoff,
                                      self._hashsize, self._mm)
        except Exception:
            res = None
        if res is not None:
            out_t, out_c, out_off = res
            for i, (seqno, _, length) in enumerate(carries):
                lo, hi = out_off[i], out_off[i + 1]
                for gp, c in zip(out_t[lo:hi].tolist(),
                                 out_c[lo:hi].tolist()):
                    self.pending.setdefault(gp, []).append(
                        (seqno, c, length))
            return
        # degraded path (native call failed mid-run): exact per-part
        # sorted intersections
        for (seqno, kmers, length) in carries:
            ek = np.sort(kmers)
            for gp, pk in enumerate(self.part_kmers):
                pk_s = np.sort(pk)
                if pk_s.size and ek.size:
                    ss = np.searchsorted(pk_s, ek)
                    valid = ss < pk_s.size
                    c = int(np.count_nonzero(pk_s[ss[valid]] == ek[valid]))
                else:
                    c = 0
                if c >= self._mm[gp] and c > 0:
                    self.pending.setdefault(gp, []).append(
                        (seqno, c, length))

    def any_pending(self) -> bool:
        """Cheap pre-check: can ANY recorded extra affect a later part?"""
        if self.probes is not None:
            return bool(self.pending)
        return bool(self.extras)

    def get(self, gp: int, qidx: int) -> List[Tuple[int, int, int]]:
        """Extras touching round part gp: [(seqno, shared_count, length)].
        All recorded extras precede query qidx by construction (serial
        resolution order)."""
        if self.probes is not None:
            return self.pending.get(gp, [])
        if not self.extras:
            return []
        pk = self._sorted_parts.get(gp)
        if pk is None:
            pk = np.sort(self.part_kmers[gp])
            self._sorted_parts[gp] = pk
        out = []
        for seqno, ek, length in self.extras:
            if pk.size and ek.size:
                ss = np.searchsorted(pk, ek)
                valid = ss < pk.size
                c = int(np.count_nonzero(pk[ss[valid]] == ek[valid]))
            else:
                c = 0
            if c > 0:
                out.append((seqno, c, length))
        return out


# ---------------------------------------------------------------------------
# parent selection (chimera.cpp find_matches / find_best_parents)
# ---------------------------------------------------------------------------

def _match_insert_arrays(query_seq: bytes, cand_list: List[int],
                         cigars: List[str], db
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """reference: find_matches (:367-413)."""
    qlen = len(query_seq)
    n = len(cand_list)
    match = np.zeros((n, qlen), dtype=np.int32)
    insert = np.zeros((n, qlen), dtype=np.int32)
    q4 = CHRMAP_4BIT[np.frombuffer(query_seq, dtype=np.uint8)]
    for i, (target, cigar) in enumerate(zip(cand_list, cigars)):
        tseq = db.getsequence(target)
        t4 = CHRMAP_4BIT[np.frombuffer(tseq, dtype=np.uint8)]
        qpos = tpos = 0
        for count, op in _CIGAR_RE.findall(cigar):
            run = int(count) if count else 1
            if op == "M":
                seg = (q4[qpos:qpos + run] & t4[tpos:tpos + run]) != 0
                match[i, qpos:qpos + run] = seg
                qpos += run
                tpos += run
            elif op == "I":
                # a trailing insertion lands at qpos == qlen; the reference
                # writes it past the row end (find_matches, chimera.cpp:395)
                # where nothing reads it — skip it here
                if qpos < qlen:
                    insert[i, qpos] = run
                tpos += run
            else:  # D
                qpos += run
    return match, insert


def find_best_parents(query_seq: bytes, cand_list: List[int],
                      cigars: List[str], db) -> Optional[Tuple[int, int]]:
    """reference: find_best_parents (:627-750): two rounds of 32-window
    smoothing + win counting; returns (candA_idx, candB_idx) or None."""
    qlen = len(query_seq)
    n = len(cand_list)
    match, _ = _match_insert_arrays(query_seq, cand_list, cigars, db)
    match = match.copy()

    best_parent_cand = [-1, -1]
    unsel = np.ones(n, dtype=bool)
    smooth = np.zeros((n, qlen), dtype=np.int32)
    maxsmooth = np.zeros(qlen, dtype=np.int32)

    for f in range(2):
        if f > 0:
            # zero every match window ending where the selected parent ties
            # the column max (delta-encoded union of [hit-W+1, hit] spans)
            prev = best_parent_cand[f - 1]
            hit = smooth[prev, WINDOW - 1:] == maxsmooth[WINDOW - 1:]
            hitpos = np.nonzero(hit)[0] + WINDOW - 1
            if hitpos.size:
                delta = np.zeros(qlen + 1, dtype=np.int32)
                np.add.at(delta, hitpos + 1 - WINDOW, 1)
                np.add.at(delta, hitpos + 1, -1)
                match[:, np.cumsum(delta[:-1]) > 0] = 0

        # windowed sums for all unselected candidates at once
        maxsmooth[:] = 0
        rows = match[unsel]
        if rows.shape[0]:
            c = np.cumsum(rows, axis=1)
            s = c.copy()
            s[:, WINDOW:] = c[:, WINDOW:] - c[:, :-WINDOW]
            smooth[unsel, WINDOW - 1:] = s[:, WINDOW - 1:]
            maxsmooth[WINDOW - 1:] = s[:, WINDOW - 1:].max(axis=0)

        wins = np.zeros(n, dtype=np.int64)
        active = maxsmooth[WINDOW - 1:] != 0
        wins[unsel] = (active
                       & (smooth[unsel][:, WINDOW - 1:]
                          == maxsmooth[WINDOW - 1:])).sum(axis=1)

        # first index with wins > 0 maximal (strict-improvement scan)
        if wins.max(initial=0) > 0:
            best_parent_cand[f] = int(np.argmax(wins))
            unsel[best_parent_cand[f]] = False
        else:
            break

    if best_parent_cand[0] >= 0 and best_parent_cand[1] >= 0:
        return best_parent_cand[0], best_parent_cand[1]
    return None


# ---------------------------------------------------------------------------
# eval_parents (chimera.cpp:1244-1886)
# ---------------------------------------------------------------------------

def _build_parent_alignment(query_seq: bytes, cigar: str, tseq: bytes,
                            maxi: np.ndarray) -> bytes:
    """reference: fill_alignment_parents (:795-880)."""
    aln = bytearray()
    is_inserted = False
    qpos = tpos = 0
    for count, op in _CIGAR_RE.findall(cigar):
        run = int(count) if count else 1
        if op == "I":
            for j in range(int(maxi[qpos])):
                if j < run:
                    aln.append(CHRMAP_UPCASE[tseq[tpos]])
                    tpos += 1
                else:
                    aln.append(ord("-"))
            is_inserted = True
        else:  # M or D
            for _ in range(run):
                if not is_inserted:
                    aln += b"-" * int(maxi[qpos])
                if op == "M":
                    aln.append(CHRMAP_UPCASE[tseq[tpos]])
                    tpos += 1
                else:
                    aln.append(ord("-"))
                qpos += 1
                is_inserted = False
    if not is_inserted:
        aln += b"-" * int(maxi[qpos])
    return bytes(aln)


def eval_parents(params: Parameters, query_seq: bytes, cand_list: List[int],
                 cigars: List[str], best: Tuple[int, int],
                 db) -> ChimeraResult:
    """reference: eval_parents (:1244-1886)."""
    qlen = len(query_seq)
    best_parents = list(best)

    # max insertions per query position over the two parents (:757-790)
    maxi = np.zeros(qlen + 1, dtype=np.int64)
    for cand in best_parents:
        pos = 0
        for count, op in _CIGAR_RE.findall(cigars[cand]):
            run = int(count) if count else 1
            if op in ("M", "D"):
                pos += run
            else:
                maxi[pos] = max(maxi[pos], run)
    alnlen = int(qlen + maxi.sum())

    paln = [
        _build_parent_alignment(query_seq, cigars[cand],
                                db.getsequence(cand_list[cand]), maxi)
        for cand in best_parents
    ]

    # query alignment string
    qaln = bytearray()
    for i in range(qlen):
        qaln += b"-" * int(maxi[i])
        qaln.append(CHRMAP_UPCASE[query_seq[i]])
    qaln += b"-" * int(maxi[qlen])
    qaln = bytes(qaln)

    q4 = CHRMAP_4BIT[np.frombuffer(qaln, dtype=np.uint8)].astype(np.int32)
    p14 = CHRMAP_4BIT[np.frombuffer(paln[0], dtype=np.uint8)].astype(np.int32)
    p24 = CHRMAP_4BIT[np.frombuffer(paln[1], dtype=np.uint8)].astype(np.int32)

    # ignore mask (:1278-1305)
    ignore = np.zeros(alnlen, dtype=bool)
    anygap = (q4 == 0) | (p14 == 0) | (p24 == 0)
    ignore |= anygap
    ignore[:-1] |= anygap[1:]
    ignore[1:] |= anygap[:-1]
    amb = (AMBIGUOUS_4BIT[q4] | AMBIGUOUS_4BIT[p14]
           | AMBIGUOUS_4BIT[p24]).astype(bool)
    ignore |= amb

    # lowercase parent symbols differing from query (:1310-1320)
    p1_disp = bytearray(paln[0])
    p2_disp = bytearray(paln[1])
    for i in range(alnlen):
        if p14[i] != 0 and p14[i] != q4[i]:
            p1_disp[i] = p1_disp[i] | 0x20
        if p24[i] != 0 and p24[i] != q4[i]:
            p2_disp[i] = p2_disp[i] | 0x20

    # diffs (:1324-1358)
    diffs = bytearray(b" " * alnlen)
    defined = (q4 != 0) & (p14 != 0) & (p24 != 0)
    same_p = p14 == p24
    for i in np.nonzero(defined)[0]:
        if same_p[i]:
            diffs[i] = ord(" ") if q4[i] == p14[i] else ord("N")
        else:
            if q4[i] == p14[i]:
                diffs[i] = ord("A")
            elif q4[i] == p24[i]:
                diffs[i] = ord("B")
            else:
                diffs[i] = ord("?")

    # vote scan (:1362-1480)
    sumA = sumB = sumN = 0
    for i in range(alnlen):
        if ignore[i]:
            continue
        d = diffs[i]
        if d == ord("A"):
            sumA += 1
        elif d == ord("B"):
            sumB += 1
        elif d != ord(" "):
            sumN += 1

    left_n = left_a = left_y = 0
    right_n, right_a, right_y = sumA, sumN, sumB
    best_h = -1.0
    best_i = -1
    best_is_reverse = False
    b_ly = b_ry = b_ln = b_rn = b_la = b_ra = 0

    for i in range(alnlen):
        if ignore[i]:
            continue
        d = diffs[i]
        if d == ord(" "):
            continue
        if d == ord("A"):
            left_y += 1
            right_n -= 1
        elif d == ord("B"):
            left_n += 1
            right_y -= 1
        else:
            left_a += 1
            right_a -= 1

        if left_y > left_n and right_y > right_n:
            left_h = left_y / ((params.opt_xn * (left_n + params.opt_dn))
                               + left_a)
            right_h = right_y / ((params.opt_xn * (right_n + params.opt_dn))
                                 + right_a)
            h = left_h * right_h
            if h > best_h:
                best_is_reverse = False
                best_h = h
                best_i = i
                b_ln, b_ly, b_la = left_n, left_y, left_a
                b_rn, b_ry, b_ra = right_n, right_y, right_a
        elif left_n > left_y and right_n > right_y:
            left_h = left_n / ((params.opt_xn * (left_y + params.opt_dn))
                               + left_a)
            right_h = right_n / ((params.opt_xn * (right_y + params.opt_dn))
                                 + right_a)
            h = left_h * right_h
            if h > best_h:
                best_is_reverse = True
                best_h = h
                best_i = i
                b_ln, b_ly, b_la = left_y, left_n, left_a
                b_rn, b_ry, b_ra = right_y, right_n, right_a

    result = ChimeraResult(Status.no_alignment,
                           best_h=best_h if best_h > 0 else 0.0)
    if best_h < 0.0:
        return result

    result.status = Status.low_score
    result.best_is_reverse = best_is_reverse

    if best_is_reverse:
        for i in range(alnlen):
            if diffs[i] == ord("A"):
                diffs[i] = ord("B")
            elif diffs[i] == ord("B"):
                diffs[i] = ord("A")

    # votes and model (:1520-1570)
    votes = bytearray(b" " * alnlen)
    model = bytearray(alnlen)
    for i in range(alnlen):
        m = ord("A") if i <= best_i else ord("B")
        model[i] = m
        v = ord(" ")
        if not ignore[i]:
            d = diffs[i]
            if d in (ord("A"), ord("B")):
                v = ord("+") if d == m else ord("!")
            elif d in (ord("N"), ord("?")):
                v = ord("0")
        votes[i] = v
        if v == ord("!"):
            diffs[i] = diffs[i] | 0x20

    # crossover region (:1557-1569)
    for i in range(best_i + 1, alnlen):
        if diffs[i] in (ord(" "), ord("A")):
            model[i] = ord("x")
        else:
            break

    # match counting (:1574-1620)
    index_a = 1 if best_is_reverse else 0
    index_b = 0 if best_is_reverse else 1
    pa4 = p14 if index_a == 0 else p24
    pb4 = p14 if index_b == 0 else p24
    keep = ~ignore
    cols = int(keep.sum())
    match_QA = int(((q4 == pa4) & keep).sum())
    match_QB = int(((q4 == pb4) & keep).sum())
    match_AB = int(((pa4 == pb4) & keep).sum())
    idx = np.arange(alnlen)
    msym = np.where(idx <= best_i, pa4, pb4)
    match_QM = int(((q4 == msym) & keep).sum())

    QA = 100.0 * match_QA / cols
    QB = 100.0 * match_QB / cols
    AB = 100.0 * match_AB / cols
    QT = max(QA, QB)
    QM = 100.0 * match_QM / cols
    divdiff = QM - QT
    divfrac = 100.0 * divdiff / QT

    sumL = b_ln + b_la + b_ly
    sumR = b_rn + b_ra + b_ry

    if (params.opt_uchime2_denovo is not None
            or params.opt_uchime3_denovo is not None):
        if match_QM == cols and QT < 100.0:
            result.status = Status.chimeric
    else:
        if best_h >= params.opt_minh:
            result.status = Status.suspicious
            if (divdiff >= params.opt_mindiv
                    and sumL >= params.opt_mindiffs
                    and sumR >= params.opt_mindiffs):
                result.status = Status.chimeric

    result.seqno_a = cand_list[best_parents[index_a]]
    result.seqno_b = cand_list[best_parents[index_b]]
    result.QA, result.QB, result.AB = QA, QB, AB
    result.QT, result.QM = QT, QM
    result.divdiff, result.divfrac = divdiff, divfrac
    result.best_left_y, result.best_left_n, result.best_left_a = b_ly, b_ln, b_la
    result.best_right_y, result.best_right_n, result.best_right_a = b_ry, b_rn, b_ra
    result.qaln = qaln
    result.paln_a = bytes(p1_disp if index_a == 0 else p2_disp)
    result.paln_b = bytes(p1_disp if index_b == 0 else p2_disp)
    result.diffs = bytes(diffs)
    result.votes = bytes(votes)
    result.model = bytes(model)
    return result


# ---------------------------------------------------------------------------
# chimeras_denovo "long read" variant
# (chimera.cpp scan_matches :438-503, find_best_parents_long :505-812,
#  eval_parents_long :995-1243)
# ---------------------------------------------------------------------------

def _scan_matches(matches: np.ndarray, percentage: float
                  ) -> Optional[Tuple[int, int]]:
    """Longest subsequence of `matches` (0/1) whose mismatch fraction is at
    most `percentage`% (reference: scan_matches, chimera.cpp:438-503).
    Returns (start, length) relative to the slice, or None."""
    score_match = percentage
    score_mismatch = percentage - 100.0
    n = len(matches)
    p = np.empty(n + 1, dtype=np.float64)
    p[0] = 0.0
    np.cumsum(np.where(matches != 0, score_match, score_mismatch), out=p[1:])
    # q[i] = max(p[i:])
    q = np.maximum.accumulate(p[::-1])[::-1]

    best_i = 0
    best_d = -1
    best_c = -1.0
    i = 1
    j = 1
    while j <= n:
        c = q[j] - p[i - 1]
        if c >= 0.0:
            d = j - i + 1
            if d > best_d:
                best_i = i
                best_d = d
                best_c = c
            j += 1
        else:
            i += 1
    if best_c >= 0.0:
        return best_i - 1, best_d
    return None


def find_best_parents_long(params: Parameters, query_seq: bytes,
                           cand_list: List[int], cigars: List[str],
                           db) -> Optional[List[Tuple[int, int, int]]]:
    """Select up to --chimeras_parents_max parents with the longest indel-free
    matching regions tiling the query (find_best_parents_long, :505-812).
    Returns [(cand_idx, start, len)] sorted by start when the query is fully
    covered by >1 parents, else None."""
    qlen = len(query_seq)
    n = len(cand_list)
    match, insert = _match_insert_arrays(query_seq, cand_list, cigars, db)

    position_used = np.zeros(qlen, dtype=bool)
    pos_remaining = qlen
    parents: List[Tuple[int, int, int]] = []

    for _ in range(params.opt_chimeras_parents_max):
        best_start = 0
        best_len = 0
        best_cand = -1
        for i in range(n):
            j = 0
            while j < qlen:
                start = j
                run = 0
                while (j < qlen and not position_used[j]
                       and (run == 0 or insert[i, j] == 0)):
                    run += 1
                    j += 1
                if run > best_len:
                    scan = _scan_matches(match[i, start:start + run],
                                         params.opt_chimeras_diff_pct)
                    if scan is not None and scan[1] > best_len:
                        best_cand = i
                        best_start = start + scan[0]
                        best_len = scan[1]
                j += 1

        if best_len >= params.opt_chimeras_length_min:
            parents.append((best_cand, best_start, best_len))
            position_used[best_start:best_start + best_len] = True
            pos_remaining -= best_len
        else:
            break

    if len(parents) > 1 and pos_remaining == 0:
        return sorted(parents, key=lambda t: t[1])
    return None


def eval_parents_long(query_seq: bytes, cand_list: List[int],
                      cigars: List[str],
                      parents: List[Tuple[int, int, int]],
                      db) -> ChimeraLongResult:
    """reference: eval_parents_long (:995-1243); always chimeric."""
    qlen = len(query_seq)
    nparents = len(parents)

    # max insertions per query position over all parents (:763-790)
    maxi = np.zeros(qlen + 1, dtype=np.int64)
    for cand, _, _ in parents:
        pos = 0
        for count, op in _CIGAR_RE.findall(cigars[cand]):
            run = int(count) if count else 1
            if op in ("M", "D"):
                pos += run
            else:
                maxi[pos] = max(maxi[pos], run)
    alnlen = int(qlen + maxi.sum())

    paln = [
        _build_parent_alignment(query_seq, cigars[cand],
                                db.getsequence(cand_list[cand]), maxi)
        for cand, _, _ in parents
    ]

    # query alignment string (fill_in_alignment_string_for_query :884-905)
    qaln = bytearray()
    for i in range(qlen):
        qaln += b"-" * int(maxi[i])
        qaln.append(CHRMAP_UPCASE[query_seq[i]])
    qaln += b"-" * int(maxi[qlen])
    qaln = bytes(qaln)

    # model string (fill_in_model_string_for_query :908-948)
    model = bytearray()
    nth = 0
    for qpos in range(qlen):
        if (nth + 1 < nparents
                and qpos >= parents[nth][1] + parents[nth][2]):
            nth += 1
        model += bytes([ord("A") + nth]) * int(maxi[qpos])
        model.append(ord("A") + nth)
    model += bytes([ord("A") + nth]) * int(maxi[qlen])

    q4 = CHRMAP_4BIT[np.frombuffer(qaln, dtype=np.uint8)].astype(np.int32)
    p4 = np.stack([
        CHRMAP_4BIT[np.frombuffer(a, dtype=np.uint8)].astype(np.int32)
        for a in paln
    ])

    # lowercase parent symbols differing from query (:1020-1026)
    disp = []
    for f in range(nparents):
        arr = np.frombuffer(paln[f], dtype=np.uint8).copy()
        low = (p4[f] != 0) & (p4[f] != q4)
        arr[low] |= 0x20
        disp.append(arr.tobytes())

    # diffs (compute_diffs :974-993): defined columns with exactly one
    # matching parent get that parent's letter
    diffs = np.full(alnlen, ord(" "), dtype=np.uint8)
    all_defined = (q4 != 0) & np.all(p4 != 0, axis=0)
    eq = p4 == q4[None, :]
    z = eq.sum(axis=0)
    single = all_defined & (z == 1)
    first = np.argmax(eq, axis=0)
    diffs[single] = (ord("A") + first[single]).astype(np.uint8)

    # global similarities (:1035-1046)
    match_QP = [int((p4[f] == q4).sum()) for f in range(nparents)]
    QP = [100.0 * m / alnlen for m in match_QP]
    QT = max(QP)

    QM = 100.0
    divfrac = 100.0 * (QM - QT) / QT

    return ChimeraLongResult(
        status=Status.chimeric,
        seqnos=[cand_list[cand] for cand, _, _ in parents],
        QP=QP, QT=QT, divfrac=divfrac,
        qaln=qaln, palns=tuple(disp), diffs=diffs.tobytes(),
        model=bytes(model))
