"""Greedy centroid clustering engine.

Mirrors reference src/core/cluster.cpp: rounds of R queries searched
against the frozen centroid index (device-batched here), then serial
resolution in query order with the same-round repair of
evaluate_extra_hits (:601-856).  Round size R reproduces the reference's
``--threads R`` behavior exactly (R=1 == cluster_core_serial); the
resolution step is inherently sequential and stays on host, matching the
reference's design where the worker pool only runs the search phase.

Counterpart of vsearch_tpu/core/cluster.py.  Once the centroid count
reaches DEVICE_MIN, candidate scoring runs on the device through the
growing k-mer index (ops/score_grow.py, kernel K4) and each round's top-K
candidates are aligned speculatively on the device (compacted prefetch,
kernels K2 and K3; under a mismatch score outside int8, each query's top-1
candidate through K6 and K7).  A failure on the device tier raises.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..params import Parameters
from ..db import Database
from ..ops import kmer as kmer_ops
from ..ops.bundle import bundle_fetch, unbundle_fetch
from ..ops.nw import AlignmentResult
from ..ops.nw_batch import _bucket
from ..ops.score_dense import RANK_MAX
from ..ops.score_grow import growing_index_class
from ..utils import maps
from ..utils.phasetimer import phase
from .searchcore import (Hit, QueryInfo, QueryWalk, align_trim,
                         fill_alignment_fields, search_acceptable_aligned,
                         search_acceptable_unaligned)
from .search import SearchContext


@dataclasses.dataclass
class ClusterInfo:
    seqno: int = 0
    clusterno: int = 0
    cigar: Optional[str] = None
    strand: int = 0


class _StrandState:
    """Per-(query, strand) state for one round (the searchinfo_s analogue)."""

    def __init__(self, qi: QueryInfo, walk: QueryWalk,
                 kmers: np.ndarray) -> None:
        self.qi = qi
        self.walk = walk
        self.kmers = kmers               # plus-strand unique kmer sample
        self.kmer_set = None             # lazily built set for shared counts
        self.accepts = 0
        self.rejects = 0

    @property
    def hits(self) -> List[Hit]:
        return self.walk.hits


def _hit_better_byid(a: Hit, b: Hit) -> bool:
    """hit_compare_byid_typed(a, b) < 0 (searchcore.cpp:133-179)."""
    if a.rejected != b.rejected:
        return not a.rejected
    if a.aligned != b.aligned:
        return a.aligned
    if not a.aligned:
        return False
    if a.id != b.id:
        return a.id > b.id
    return a.target < b.target


def _hit_better_bysize(a: Hit, b: Hit, db) -> bool:
    """hit_compare_bysize_typed(a, b) < 0 (searchcore.cpp:182-243)."""
    if a.rejected != b.rejected:
        return not a.rejected
    if a.rejected:
        return False
    if a.aligned != b.aligned:
        return a.aligned
    if not a.aligned:
        return False
    aa, ba = db.getabundance(a.target), db.getabundance(b.target)
    if aa != ba:
        return aa > ba
    if a.id != b.id:
        return a.id > b.id
    return a.target < b.target


def find_best2(params: Parameters, db, si_p: _StrandState,
               si_m: Optional[_StrandState]) -> Optional[Hit]:
    """search_findbest2_byid/bysize (searchcore.cpp:960-1025)."""
    better = (lambda a, b: _hit_better_bysize(a, b, db)) \
        if params.opt_sizeorder else _hit_better_byid
    best: Optional[Hit] = None
    for hit in si_p.hits:
        if best is None or better(hit, best):
            best = hit
    if params.opt_strand and si_m is not None:
        for hit in si_m.hits:
            if best is None or better(hit, best):
                best = hit
    if best is not None and not best.accepted:
        best = None
    return best


class ClusterEngine:
    # centroid count from which candidate scoring moves to the device
    # (below it, per-round kernel latency beats the host postings cost;
    # above it, host counting scales with centroids x postings while the
    # device scan stays one packed-bit pass)
    DEVICE_MIN = 4096

    # the most positions the rank key orders (a multiple of K4's
    # 4096-position block); beyond it the host tier scores
    DEVICE_MAX = RANK_MAX & ~4095

    def __init__(self, params: Parameters, db: Database,
                 ctx: SearchContext) -> None:
        self.params = params          # effective (clamped) parameters
        self.db = db
        self.ctx = ctx
        self.index = ctx.index
        self.tophits = ctx.tophits
        self.clusterinfo = [ClusterInfo() for _ in range(db.seqcount)]
        self.clusters = 0
        self._extras_postings = None   # per-round native postings
        self._extras_cache_len = -1
        self._dev_index = None         # the growing index once active
        # (query, strand, target) -> alignment, prepared per round by
        # _prealign_carry
        self._repair_cache: Dict[Tuple[int, int, int], AlignmentResult] = {}

    # -- growing device index (ops/score_grow.py) ------------------------

    def _device_capacity(self, count: int) -> int:
        """Index capacity sized ONCE to the run's upper bound (every input
        sequence could become a centroid): no mid-run rebuild means no
        re-upload.  Device zeros cost no upload (score_grow build scatters
        only occupied entries), so over-allocation costs device memory and
        K4's scan of the empty columns."""
        cap = max(2 * count, 40960, self.db.seqcount)
        return min((cap + 4095) // 4096 * 4096, self.DEVICE_MAX)

    def _device_sync(self, new_entries) -> None:
        """Activate or grow the device-side index after a round added
        centroids.  new_entries: [(kmers, length, seqno)] this round."""
        if (self._dev_index is not None
                and self._dev_index.append_round(new_entries)):
            return
        # activation, or growth past the capacity sized at activation
        count = self.index.count
        if count < self.DEVICE_MIN or count > self.DEVICE_MAX:
            self._dev_index = None
            return
        # several ranks: ShardedGrowingKmerIndex
        self._dev_index = growing_index_class().build(
            self.index.wordlength, self.index.kmer_lists_by_position(),
            list(self.index.lengths), list(self.index.mapping),
            capacity=self._device_capacity(count),
            device=self.ctx.aligner.device)
        self._attach_codes()

    def _attach_codes(self) -> None:
        """Device sequence codes for the prefetch: width covers the
        longest DB sequence, so no centroid is ever truncated."""
        maxlen = max((self.db.getsequencelen(s)
                      for s in range(self.db.seqcount)), default=1)
        if maxlen <= self.PREFETCH_MAXLEN:
            self._dev_index.attach_codes(_bucket(max(maxlen, 1)),
                                         self.db.getsequence)

    # -- search phase (device-batched, frozen index) --------------------

    def _round_dispatch(self, seqnos: List[int]) -> dict:
        """Host prep + async device dispatch for one round.

        When the device tier is active the candidate top-k (and the
        prefetch alignment chained off it) is dispatched asynchronously
        with the device->host copy started immediately, so the transfer
        rides under the PREVIOUS round's host resolution (the 1-round-lag
        pipeline in run()); on the host tier candidates are computed
        synchronously here."""
        params = self.params
        units: List[_StrandState] = []
        kmer_lists = []
        per_query: List[Tuple[_StrandState, Optional[_StrandState]]] = []
        with phase("prep"):
            for seqno in seqnos:
                seq = self.db.getsequence(seqno)
                states = []
                for strand in range(2 if params.opt_strand else 1):
                    qseq = (seq if strand == 0
                            else maps.reverse_complement(seq))
                    qi = QueryInfo(query_head=self.db.getheader(seqno),
                                   qsequence=qseq, qseqlen=len(qseq),
                                   qsize=self.db.getabundance(seqno),
                                   strand=strand, query_no=seqno)
                    kmers = kmer_ops.unique_kmer_set(
                        qseq, self.index.wordlength, params.opt_qmask)
                    qi.kmersamplecount = int(kmers.size)
                    walk = QueryWalk(params, qi, self.db, [])
                    st = _StrandState(qi, walk, kmers)
                    units.append(st)
                    kmer_lists.append(kmers)
                    states.append(st)
                per_query.append((states[0],
                                  states[1] if len(states) > 1 else None))

        minmatches = [self.ctx._minmatches(st.qi.kmersamplecount)
                      for st in units]
        st_out = {"units": units, "per_query": per_query,
                  "minmatches": minmatches, "device": False}
        if (self._dev_index is not None
                and self._dev_index.n == self.index.count
                and self._dev_index.supports(kmer_lists)):
            dev = self._dev_index
            with phase("dispatch"):
                q, pending = dev.topk_dispatch(kmer_lists, self.tophits)
                prefetch = self._prefetch_dispatch(units, pending,
                                                   minmatches)
                # the device->host copies start now, so they overlap host
                # work
                bundled = bundle_fetch(pending, prefetch)
            st_out.update(device=True, dev=dev, pending=pending,
                          bundled=bundled)
        else:
            with phase("host_topk"):
                st_out["cand_lists"] = \
                    self.index.candidates_for_query_batch(
                        kmer_lists, self.tophits, minmatches)
        return st_out

    def _round_complete(self, st_in: dict
                        ) -> List[Tuple[_StrandState, Optional[_StrandState]]]:
        """Fetch the round's candidates and run the accept/reject walks."""
        units = st_in["units"]
        per_query = st_in["per_query"]
        minmatches = st_in["minmatches"]
        prefetched: Optional[_PrefetchStore] = None
        if st_in["device"]:
            dev = st_in["dev"]
            pending = st_in["pending"]
            with phase("topk_fetch"):
                topk_h, pref_h = unbundle_fetch(st_in["bundled"])
            cand_lists = dev.topk_cut(
                [(nq, f) for (nq, _), f in zip(pending, topk_h)],
                minmatches)
            with phase("prefetch"):
                prefetched = _PrefetchStore(self, units, pending, pref_h,
                                            topk_h, dev)
        else:
            cand_lists = st_in["cand_lists"]
        for st, cands in zip(units, cand_lists):
            st.walk.candidates = cands
        with phase("walk"):
            self._run_walks(units, prefetched)
        return per_query

    def _run_walks(self, units: List[_StrandState],
                   prefetched: Optional["_PrefetchStore"]) -> None:
        """The round's accept/reject walks, in lockstep alignment rounds
        (as SearchContext._run_walks)."""
        active = list(range(len(units)))
        while active:
            pair_list = []
            owners = []
            served = []
            pre_results: Dict[Tuple[int, int], AlignmentResult] = {}
            any_request = False
            for w in active:
                targets = units[w].walk.advance()
                if targets:
                    any_request = True
                for t in targets:
                    entry = prefetched.take(w, t) if prefetched else None
                    if entry is not None:
                        served.append((w, t, entry))
                    else:
                        pair_list.append((units[w].qi.qsequence, t))
                        owners.append((w, t))
            if not any_request:
                break
            if served:
                pre_results.update(prefetched.assemble(served))
            results = self.ctx.align_pairs(pair_list) if pair_list else []
            per_walk: Dict[int, Dict[int, AlignmentResult]] = {}
            for (w, t), res in zip(owners, results):
                per_walk.setdefault(w, {})[t] = res
            for (w, t), res in pre_results.items():
                per_walk.setdefault(w, {})[t] = res
            nxt = []
            for w in active:
                if w in per_walk:
                    units[w].walk.supply(per_walk[w])
                if not units[w].walk.done:
                    nxt.append(w)
            active = nxt
        for st in units:
            st.accepts = st.walk.accepts
            st.rejects = st.walk.rejects

    # -- top-K prefetch over the growing index --------------------------

    PREFETCH_MAXLEN = 4096

    # speculative alignment depth: candidates 0..K-1 of every round query
    # align on device chained off the top-k output.  ~92% of all walk
    # alignment requests land within the first 8 candidates (measured on
    # the 50k bench workload), and unused lanes cost idle K2 work plus
    # lazy (never-run) host assembly — nothing else.
    PREFETCH_K = 8

    # compacted-lane budget per 512-query chunk (mean useful candidates
    # per query is ~2-3 at cluster identities, but candidate LISTS run
    # longer; truncated entries simply go to the host aligner).  One K2
    # call covers all lanes.
    PREFETCH_LANES = 2048

    def _prefetch_dispatch(self, units, pending, minmatches):
        """Speculatively align each round query's minmatches-passing
        top-K candidates, compacted into dense device lanes chained off
        the un-fetched top-k output (nw_batch.compact_gather).  Top-1
        coverage is not enough for clustering: walks burn through many
        REJECTED candidates before minting a centroid, and those reject
        alignments otherwise land on the host aligner.  The compacted form
        needs the aligner's row wire; on the codes wire each query's top-1
        candidate is aligned instead ((score, overflow, ops) per chunk)."""
        dev = self._dev_index
        if (dev.codes is None or self.ctx.scheme.force_scalar_fallback
                or not pending):
            return None
        handles = []
        lo = 0
        for cnt, (vals, idx) in pending:
            qseqs = [units[lo + r].qi.qsequence for r in range(cnt)]
            mm = np.full(idx.shape[0], 2**30, dtype=np.int32)
            mm[:cnt] = minmatches[lo:lo + cnt]
            lo += cnt
            if not any(qseqs):
                handles.append(None)
                continue
            if not self.ctx.aligner.row_wire:
                # the codes wire has no compacted form: each query's top-1
                # candidate (vsearch_tpu/core/cluster.py:417-431)
                handles.append(self.ctx.aligner.dispatch_indexed(
                    qseqs, idx.shape[0], idx[:, 0], dev.codes, dev.tlen_dev,
                    dev.codes_width))
                continue
            meta, ops = self.ctx.aligner.dispatch_compact(
                qseqs, idx.shape[0], vals, idx, mm,
                min(self.PREFETCH_K, idx.shape[1]), self.PREFETCH_LANES,
                dev.codes, dev.tlen_dev, dev.codes_width, dev.n)
            handles.append({"mat": meta, "ops": ops})
        return handles

    # -- same-round repair (evaluate_extra_hits) ------------------------

    def _extras_shared_counts(self, si: _StrandState,
                              extras: List[_StrandState]) -> np.ndarray:
        """Per-extra shared-unique-kmer counts for one query state."""
        from .. import native
        if self._extras_cache_len > len(extras):
            self._extras_postings = None       # new round
            self._extras_cache_len = -1
        if self._extras_postings is None and native.available():
            self._extras_postings = native.Postings(self.index.hashsize)
            self._extras_cache_len = 0
        p = self._extras_postings
        if p:
            while self._extras_cache_len < len(extras):
                e = extras[self._extras_cache_len]
                p.add(e.kmers, e.qi.qseqlen, self._extras_cache_len)
                self._extras_cache_len += 1
            shared_all = np.zeros(len(extras), dtype=np.int64)
            pos, cnt = p.counts(si.kmers)
            shared_all[pos] = cnt
            return shared_all
        # numpy fallback: sorted query kmers intersected with the concat
        if si.kmer_set is None:
            si.kmer_set = np.sort(si.kmers)
        sk = si.kmer_set
        concat = np.concatenate([s.kmers for s in extras])
        bounds = np.zeros(len(extras) + 1, dtype=np.int64)
        np.cumsum([s.kmers.size for s in extras], out=bounds[1:])
        if sk.size and concat.size:
            ss = np.searchsorted(sk, concat)
            hit_mask = np.zeros(concat.size, dtype=np.int64)
            valid = ss < sk.size
            hit_mask[valid] = sk[ss[valid]] == concat[valid]
            csum = np.zeros(concat.size + 1, dtype=np.int64)
            np.cumsum(hit_mask, out=csum[1:])
            return csum[bounds[1:]] - csum[bounds[:-1]]
        return np.zeros(len(extras), dtype=np.int64)

    def _evaluate_extra_hits(self, si: _StrandState,
                             extras: List[_StrandState]) -> None:
        """reference: cluster.cpp evaluate_extra_hits (:601-856)."""
        params = self.params
        hit_capacity = min(params.opt_maxaccepts + params.opt_maxrejects - 1,
                           self.tophits)
        hits = si.hits
        added = 0
        if extras:
            # shared-kmer counts against ALL extras in one pass over a
            # per-round incremental postings index (native), falling back
            # to a vectorized sorted-intersection sweep
            shared_all = self._extras_shared_counts(si, extras)
            # search_enough_kmers (searchcore.cpp:252-257), vectorized:
            # the eligible set is tiny, so the per-extra python loop runs
            # only over it (wide pipelined rounds carry hundreds of
            # extras per query)
            elig = np.nonzero(
                (shared_all >= params.opt_minwordmatches)
                | (shared_all >= si.qi.kmersamplecount))[0]
            for ei in elig.tolist():
                sic = extras[ei]
                shared = int(shared_all[ei])
                length = sic.qi.qseqlen
                x = len(hits)
                while x > 0 and (
                        hits[x - 1].count < shared
                        or (hits[x - 1].count == shared
                            and self.db.getsequencelen(hits[x - 1].target)
                            > length)):
                    x -= 1
                if x < hit_capacity:
                    if len(hits) >= hit_capacity:
                        hits.pop()
                    hit = Hit(target=sic.qi.query_no, strand=si.qi.strand,
                              count=shared)
                    hits.insert(x, hit)
                    added += 1

        if added == 0:
            return

        # batch-align the repair candidates this walk may request: the
        # host tier's per-call cost is ~2 ms regardless of batch size
        # (scalar serial path) vs ~0.07 ms/pair batched through the SIMD
        # groups, so one speculative call beats per-hit singles whenever
        # two or more extras could align.  Aligning a pair the walk never
        # reaches (early accept) is wasted DP, not a semantic change.
        cache = self._repair_cache
        need = [h.target for h in hits
                if not h.aligned
                and (si.qi.query_no, si.qi.strand, h.target) not in cache
                and search_acceptable_unaligned(params, si.qi, self.db,
                                                h.target)]
        if len(need) > 1:
            for t, r in zip(need, self.ctx.align_pairs(
                    [(si.qi.qsequence, t) for t in need])):
                cache[(si.qi.query_no, si.qi.strand, t)] = r

        si.rejects = 0
        si.accepts = 0
        for hit in hits:
            hit.accepted = False
            hit.rejected = False

        for hit in hits:
            if not (si.accepts < params.opt_maxaccepts
                    and si.rejects < params.opt_maxrejects):
                break
            if not hit.aligned:
                if search_acceptable_unaligned(params, si.qi, self.db,
                                               hit.target):
                    result = cache.get(
                        (si.qi.query_no, si.qi.strand, hit.target))
                    if result is None:
                        result = self.ctx.align_pairs(
                            [(si.qi.qsequence, hit.target)])[0]
                    fill_alignment_fields(hit, si.qi, self.db, result)
                    align_trim(hit, params)
                else:
                    hit.rejected = True
                    si.rejects += 1
            if not hit.rejected:
                if search_acceptable_aligned(params, si.qi, self.db, hit):
                    si.accepts += 1
                else:
                    si.rejects += 1

        # delete all undetermined hits (scan from the end)
        new_count = len(hits)
        for t in range(len(hits) - 1, -1, -1):
            if not hits[t].accepted and not hits[t].rejected:
                new_count = t
        del hits[new_count:]

    # -- main loop ------------------------------------------------------

    def _resolve_round(self, per_query, carry: List[_StrandState],
                       on_hit, on_nohit) -> List[_StrandState]:
        """Serial resolution of a completed round.  ``carry`` holds the
        PREVIOUS round's new centroids when the run loop pipelines (the
        round was dispatched against the index frozen one round earlier,
        so those centroids must enter the same exact repair as same-round
        ones — the repair is snapshot-depth-invariant, the property the
        reference's own thread scaling relies on, cluster.cpp:877-1030).
        Returns THIS round's new centroids for the next round's carry."""
        params = self.params
        extras: List[_StrandState] = list(carry)
        new_extras: List[_StrandState] = []
        new_entries = []           # device-index appends this round
        self._extras_postings = None
        self._extras_cache_len = -1
        self._prealign_carry(per_query, carry)
        for si_p, si_m in per_query:
            for si in (si_p, si_m):
                if si is not None:
                    self._evaluate_extra_hits(si, extras)
            best = find_best2(params, self.db, si_p, si_m)
            myseqno = si_p.qi.query_no
            info = self.clusterinfo[myseqno]
            info.seqno = myseqno
            if best is not None:
                target = best.target
                on_hit(best, self.clusterinfo[target].clusterno,
                       si_p, si_m)
                info.clusterno = self.clusterinfo[target].clusterno
                info.cigar = best.nwalignment
                info.strand = best.strand
            else:
                extras.append(si_p)
                new_extras.append(si_p)
                info.clusterno = self.clusters
                info.cigar = None
                info.strand = 0
                self.index.add_sequence(myseqno, self.db,
                                        params.opt_qmask)
                new_entries.append(
                    (self.index._kmer_lists[-1],
                     self.db.getsequencelen(myseqno), myseqno))
                on_nohit(self.clusters, si_p)
                self.clusters += 1
        if new_entries:
            self._device_sync(new_entries)
        return new_extras

    def _prealign_carry(self, per_query, carry: List[_StrandState]) -> None:
        """Batch-align the (round query, carried centroid) pairs the repair
        will need, in ONE aligner call instead of per-pair singles.

        The repair's alignment calls have no side effects — aligning a pair
        the walk never reaches is wasted DP, not a semantic change — so a
        speculative batch over every eligible (shared k-mers >= minword-
        matches, passes the unaligned gates) pair is exact; pairs the
        batch misses (e.g. same-round extras, tiny-query kmersamplecount
        gate) still align lazily in _evaluate_extra_hits."""
        from .. import native
        self._repair_cache = {}
        params = self.params
        mwm = params.opt_minwordmatches
        if not carry or mwm <= 0 or not native.available():
            return
        units = [si for pq in per_query for si in pq if si is not None]
        if not units:
            return
        tbuf, toff = native._concat_kmer_lists([c.kmers for c in carry])
        qbuf, qoff = native._concat_kmer_lists([u.kmers for u in units])
        res = native.cross_counts(tbuf, toff, qbuf, qoff,
                                  self.index.hashsize, [mwm] * len(carry))
        if res is None:
            return
        out_t, _, out_off = res
        pairs: List[Tuple[bytes, int]] = []
        keys: List[Tuple[int, int, int]] = []
        for ui, u in enumerate(units):
            for ti in out_t[out_off[ui]:out_off[ui + 1]].tolist():
                target = carry[ti].qi.query_no
                if search_acceptable_unaligned(params, u.qi, self.db,
                                               target):
                    pairs.append((u.qi.qsequence, target))
                    keys.append((u.qi.query_no, u.qi.strand, target))
        if pairs:
            for key, r in zip(keys, self.ctx.align_pairs(pairs)):
                self._repair_cache[key] = r

    # round width once the device tier is active: wide rounds amortize
    # the per-round dispatch and fetch and fill the 512-query K4 launch
    DEVICE_ROUND = 512

    def run(self, round_size: int,
            on_hit: Callable[[Hit, int, _StrandState, Optional[_StrandState]], None],
            on_nohit: Callable[[int, _StrandState], None],
            progress=None) -> None:
        params = self.params
        seqcount = self.db.seqcount
        lastlength = None
        seqno = 0
        nt_done = 0
        prev: Optional[dict] = None        # in-flight dispatched round
        carry: List[_StrandState] = []     # prev round's new centroids
        while seqno < seqcount or prev is not None:
            width = (self.DEVICE_ROUND if self._dev_index is not None
                     else round_size)
            round_seqnos = []
            while seqno < seqcount and len(round_seqnos) < width:
                length = self.db.getsequencelen(seqno)
                if (params.opt_cluster_smallmem is not None
                        and params.opt_usersort == 0
                        and lastlength is not None and length > lastlength):
                    raise ValueError("Sequences not sorted by length and "
                                     "--usersort not specified.")
                lastlength = length
                round_seqnos.append(seqno)
                nt_done += length
                seqno += 1
            if progress is not None:
                progress.update(nt_done)

            st = self._round_dispatch(round_seqnos) if round_seqnos else None
            if prev is not None:
                # 1-round-lag pipeline: the device scores round i+1 (and
                # its prefetch DP) while the host resolves round i.  st
                # was dispatched BEFORE this resolution, so the new
                # centroids it misses become its carry.
                per_query = self._round_complete(prev)
                with phase("resolve"):
                    carry = self._resolve_round(per_query, carry,
                                                on_hit, on_nohit)
                prev = None
            if st is not None:
                if st["device"]:
                    prev = st
                else:
                    # resolved in-iteration: the NEXT dispatch happens
                    # after this resolution, so nothing carries forward
                    per_query = self._round_complete(st)
                    with phase("resolve"):
                        self._resolve_round(per_query, carry, on_hit,
                                            on_nohit)
                    carry = []


class _PrefetchStore:
    """Lazily-assembled speculative alignments for one round.

    Maps (unit index, target seqno) -> fetched device alignment row (RLE
    ops column + score) for every valid compacted prefetch lane.  Host
    assembly (ops -> CIGAR + statistics) runs ONLY for pairs a walk
    actually requests, batched per lockstep wave into one threaded native
    call per ops matrix — unused speculative lanes cost nothing on the
    host.  Pairs the store lacks (invalid, overflow, SIMD-ineligible,
    ops beyond the cut, or beyond the lanes) go to the normal align_pairs
    path, so coverage is a pure performance knob."""

    def __init__(self, engine, units, pending, pref_h, topk_h, dev):
        from ..ops.nw import fits_simd
        self.engine = engine
        self.units = units
        self.map: Dict[Tuple[int, int], tuple] = {}
        lo = 0
        for (cnt, _), pf, (topv, topi) in zip(pending, pref_h, topk_h):
            if isinstance(pf, dict):
                # compact form: meta rows q_idx/pos/score/overflow/nsteps
                ops = pf["ops"]
                q_idx, pos, score, over, nsteps = pf["mat"]
                valid = (pos < 2**30) & (pos < dev.n) & (over == 0) \
                    & (q_idx < cnt) & (nsteps <= ops.shape[0])
                lanes = [(lidx, int(pos[lidx]), lo + int(q_idx[lidx]))
                         for lidx in np.nonzero(valid)[0].tolist()]
            elif pf is not None:
                # top-1 form (vsearch_tpu/core/cluster.py:763-785): one
                # (score, overflow, ops) triple, lane r for query r
                score, over, ops = pf
                valid = ((topv[:cnt, 0] >= 0) & (topi[:cnt, 0] < dev.n)
                         & ~over[:cnt])
                lanes = [(r, int(topi[r, 0]), lo + r)
                         for r in np.nonzero(valid)[0].tolist()]
            else:
                lanes = []
            for lidx, p, w in lanes:
                seqno = int(dev.seqnos[p])
                qlen = units[w].qi.qseqlen
                tlen = int(dev.lengths[p])
                if (qlen == 0 or tlen == 0 or tlen > dev.codes_width
                        or not fits_simd(qlen, tlen)):
                    continue
                self.map[(w, seqno)] = (ops, lidx, int(score[lidx]))
            lo += cnt

    def take(self, w: int, t: int):
        return self.map.pop((w, t), None)

    def assemble(self, entries) -> Dict[Tuple[int, int], AlignmentResult]:
        """entries: [(w, t, store_row)] -> finished AlignmentResults,
        one native assemble call per distinct ops matrix."""
        from .. import native
        eng = self.engine
        out: Dict[Tuple[int, int], AlignmentResult] = {}
        groups: Dict[int, tuple] = {}
        for w, t, (ops, col, score) in entries:
            groups.setdefault(id(ops), (ops, []))[1].append(
                (w, t, col, score))
        for ops, items in groups.values():
            cols = [col for (_, _, col, _) in items]
            qs = [self.units[w].qi.qsequence for (w, _, _, _) in items]
            ts = [eng.db.getsequence(t) for (_, t, _, _) in items]
            res = native.assemble_batch(np.asarray(ops), cols, qs, ts,
                                        eng.ctx.scheme.n_mismatch)
            if res is not None:
                for (w, t, _, score), (cigar, aligned, matches, mism,
                                       gaps) in zip(items, res):
                    out[(w, t)] = AlignmentResult(score, cigar, aligned,
                                                  matches, mism, gaps)
            else:
                for (w, t, col, score) in items:
                    out[(w, t)] = eng.ctx.aligner.assemble_one(
                        score, np.asarray(ops)[:, col],
                        self.units[w].qi.qsequence,
                        eng.db.getsequence(t))
        return out
