"""Batched search driver (usearch_global engine).

Batched restructure of reference src/core/search.cpp +
commands/usearch_global.cpp: instead of one-thread-one-query with early
exits, queries are processed in host batches; per batch

  1. shared-kmer counts for every (query, strand) run on the device over
     the packed-bit incidence index (ops/score.py, kernel K1),
  2. exact top-K candidate selection replays the reference heap order,
  3. every query is aligned with its top-1 candidate on the device, chained
     off the top-k output (ops/nw_batch.py, kernels K2 and K3, or K6 and
     K7 under a mismatch score outside int8),
  4. the per-query accept/reject walks advance in lockstep: each round
     collects every walk's MAXDELAYED alignment batch and aligns the union
     in one batched call (ops/nw_batch.py),
  5. hits are emitted in query order (the reference's single-thread order).

A failure on the device path raises: nothing falls back silently.

This aligns exactly the pairs the reference aligns — no speculative extra
DP work — while keeping device calls O(rounds) instead of O(queries).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..params import Masking, Parameters
from ..db import Database
from ..index import KmerIndex
from ..utils.phasetimer import phase
from ..ops import kmer as kmer_ops
from ..ops.nw import (AlignmentResult, ScoreScheme, SHRT_MAX, align_pair_host,
                      fits_simd)
from ..utils import maps
from . import mask as mask_mod
from .searchcore import (Hit, QueryInfo, MAXDELAYED, QueryWalk, join_hits)


@dataclasses.dataclass
class QueryTask:
    """One query as read from the input, with per-strand masked forms."""
    query_head: bytes
    qsize: int
    query_no: int
    seqs: List[bytes]                  # masked sequence per strand
    hits: List[Optional[List[Hit]]]    # filled per strand


_db_cache: dict = {}


def load_db_and_index(params: Parameters, filename: str,
                      do_mask: bool = True) -> Tuple[Database, KmerIndex]:
    """UDB-aware database + k-mer index loader.

    Mirrors the four reference sites that accept a UDB --db
    (usearch_global.cpp:562-589, orient.cpp:179-202, sintax.cpp:709-726,
    chimera.cpp:2492-2515 uchime_ref).  The UDB path skips masking (the
    stored sequences/postings were masked at makeudb time).

    Embedding/session reuse: repeated runs against the same immutable --db
    in one process (server or notebook embedding) reuse the loaded
    Database/KmerIndex — and the device index cached on it — instead of
    re-reading, re-masking and re-uploading.  Callers of this function
    never mutate the returned objects (the mutating paths, clustering and
    denovo chimera, build their own empty index)."""
    import os as _os
    try:
        st = _os.stat(filename)
        key = (filename, st.st_mtime_ns, st.st_size, params.opt_wordlength,
               params.opt_dbmask, params.opt_hardmask, do_mask,
               params.opt_minseqlength, params.opt_maxseqlength,
               params.opt_minsize, params.opt_maxsize,
               params.opt_sizein, params.opt_notrunclabels)
    except OSError:
        key = None
    if key is not None and key in _db_cache:
        return _db_cache[key]
    from ..io import udb as udb_io
    db = Database()
    index = KmerIndex(params.opt_wordlength)
    if udb_io.detect_isudb(filename):
        udb_io.read_udb(filename, params, db, index, True)
    else:
        db.read(filename, params)
        if do_mask:
            if params.opt_dbmask == Masking.dust:
                mask_mod.dust_all(db, params)
            elif params.opt_dbmask == Masking.soft and params.opt_hardmask:
                mask_mod.hardmask_all(db)
        index.add_all_sequences(db, params.opt_dbmask, params)
    if key is not None:
        _db_cache.clear()          # hold at most one database
        _db_cache[key] = (db, index)
    return db, index


class SearchContext:
    """Everything a search run needs (the search_cli_state_s analogue)."""

    def __init__(self, params: Parameters, db: Database, index: KmerIndex,
                 tophits: int, scheme: ScoreScheme, aligner, device_index):
        self.params = params
        self.db = db
        self.index = index
        self.tophits = tophits
        self.scheme = scheme
        self.aligner = aligner
        self.device_index = device_index

    @classmethod
    def build(cls, params: Parameters, db: Database,
              index: Optional[KmerIndex] = None) -> "SearchContext":
        """Mirror of search_prep (usearch_global.cpp:537-615): mask DB, build
        index, clamp maxaccepts/maxrejects, compute tophits.  The aligner
        always runs on the port's device; the device k-mer index is built
        for a DB of at least 512 sequences (below that the host index
        scores), sharded over the ranks of a process group."""
        if index is None:
            if params.opt_dbmask == Masking.dust:
                mask_mod.dust_all(db, params)
            elif params.opt_dbmask == Masking.soft and params.opt_hardmask:
                mask_mod.hardmask_all(db)
            index = KmerIndex(params.opt_wordlength)
            index.add_all_sequences(db, params.opt_dbmask, params)

        effective = dataclasses.replace(params)
        seqcount = db.seqcount
        if effective.opt_maxrejects == 0 or effective.opt_maxrejects > seqcount:
            effective.opt_maxrejects = seqcount
        if effective.opt_maxaccepts == 0 or effective.opt_maxaccepts > seqcount:
            effective.opt_maxaccepts = seqcount
        tophits = min(effective.opt_maxaccepts + effective.opt_maxrejects
                      + MAXDELAYED, seqcount)
        from .. import device as device_mod
        from ..ops.nw_batch import BatchAligner, _bucket
        from ..ops.score import DeviceKmerIndex
        dev = device_mod.current()
        aligner = BatchAligner(ScoreScheme.from_params(params), dev)
        device_index = None
        if index.count >= 512:
            # several ranks: the positions are sharded over them
            # (parallel/sharded_index.py)
            from ..parallel.mesh import active_mesh
            if active_mesh() is not None:
                from ..parallel.sharded_index import ShardedKmerIndex
                index_cls = ShardedKmerIndex
            else:
                index_cls = DeviceKmerIndex
            # ride the load_db_and_index session cache: the packed
            # device tensors are immutable alongside the host index
            device_index = getattr(index, "_device_index", None)
            if (type(device_index) is not index_cls
                    or device_index.n != index.count
                    or device_index.device != dev):
                device_index = index_cls(
                    index.wordlength, index.kmer_lists_by_position(),
                    np.asarray(index.lengths), np.asarray(index.mapping),
                    device=dev)
                index._device_index = device_index
            # device-resident DB codes enable the top-1 prefetch
            # alignment (dispatched device-to-device off the top-k
            # output, uploading only query codes)
            device_index.attach_db_codes(db, _bucket)
        return cls(effective, db, index, tophits,
                   ScoreScheme.from_params(params), aligner, device_index)

    # -- alignment ------------------------------------------------------

    def align_pairs(self, pairs: Sequence[Tuple[bytes, int]]
                    ) -> List[AlignmentResult]:
        """Align (qseq, target_seqno) pairs with search16 semantics +
        linear-memory fallback for sentinel scores."""
        return self.align_pairs_end(self.align_pairs_begin(pairs))

    def align_pairs_begin(self, pairs: Sequence[Tuple[bytes, int]]):
        """align_pairs in two halves: this one aligns on the host the
        pairs the batched aligner does not take and queues the others
        (BatchAligner.align_pairs_begin: on the device, not waited for);
        align_pairs_end(handle) gives the results."""
        with phase("align"):
            results, pending = self._host_aligned(pairs)
            return pairs, results, pending, self.aligner.align_pairs_begin(
                [pairs[i][0] for i in pending],
                [self.db.getsequence(pairs[i][1]) for i in pending])

    def align_pairs_end(self, handle) -> List[AlignmentResult]:
        """The results of align_pairs_begin's handle, in pair order."""
        pairs, results, pending, batch = handle
        with phase("align"):
            for i, res in zip(pending, self.aligner.align_pairs_end(batch)):
                results[i] = res
            return self._linmem_fallback(pairs, results)

    def _host_aligned(self, pairs: Sequence[Tuple[bytes, int]]):
        """(results, pending): the pairs the batched aligner cannot take
        aligned on the host, None for the others, whose indices pending
        lists."""
        results: List[Optional[AlignmentResult]] = [None] * len(pairs)
        pending: List[int] = []
        for idx, (qseq, t) in enumerate(pairs):
            tseq = self.db.getsequence(t)
            if (self.scheme.force_scalar_fallback
                    or not fits_simd(len(qseq), len(tseq))
                    or len(qseq) == 0 or len(tseq) == 0):
                results[idx] = align_pair_host(self.scheme, qseq, tseq)
            else:
                pending.append(idx)
        return results, pending

    def _linmem_fallback(self, pairs: Sequence[Tuple[bytes, int]],
                         results: List[AlignmentResult]
                         ) -> List[AlignmentResult]:
        """Sentinel scores aligned again in linear memory (reference:
        align_delayed, searchcore.cpp:806-832)."""
        for i, res in enumerate(results):
            if res.score == SHRT_MAX:
                from ..ops.linmem import linmem_align
                results[i] = linmem_align(self.scheme, pairs[i][0],
                                          self.db.getsequence(pairs[i][1]))
        return results

    # -- scoring --------------------------------------------------------

    def _candidates_batch(self, kmer_lists: List[np.ndarray],
                          samplecounts: List[int]
                          ) -> List[List[Tuple[int, int]]]:
        """Per-query candidate lists in reference heap order."""
        if self.device_index is not None:
            vals, idx = self.device_index.topk(kmer_lists, self.tophits)
            return self._candidates_from_topk(vals, idx, samplecounts)
        return self.index.candidates_for_query_batch(
            kmer_lists, self.tophits,
            [self._minmatches(sc) for sc in samplecounts])

    def _candidates_from_topk(self, vals, idx, samplecounts: List[int]
                              ) -> List[List[Tuple[int, int]]]:
        """Vectorized cut of the device top-k rows at the first entry below
        minmatches (values are non-increasing per row)."""
        di = self.device_index
        nq = len(samplecounts)
        if vals.shape[1] == 0:
            return [[] for _ in range(nq)]
        sc = np.asarray(samplecounts, dtype=np.int64)
        mwm = self.params.opt_minwordmatches
        mwm_u = mwm & 0xFFFFFFFF if mwm < 0 else mwm
        minm = np.minimum(mwm_u, sc)
        valid = (vals >= minm[:, None]) & (idx < di.n)
        ncand = np.where(valid.all(axis=1), vals.shape[1],
                         np.argmin(valid, axis=1))
        seqnos = di.seqno_by_pos[np.minimum(idx, di.n - 1)]
        vals_l = vals.tolist()
        seqnos_l = seqnos.tolist()
        return [list(zip(seqnos_l[qi][:ncand[qi]], vals_l[qi][:ncand[qi]]))
                for qi in range(nq)]

    def _minmatches(self, kmersamplecount: int) -> int:
        # the reference casts opt_minwordmatches to unsigned before the min
        # (searchcore.cpp:320), so a negative value means "kmersamplecount"
        mwm = self.params.opt_minwordmatches
        mwm_u = mwm & 0xFFFFFFFF if mwm < 0 else mwm
        return min(mwm_u, kmersamplecount)

    # -- batched query processing ---------------------------------------

    def prepare_tasks(self, recs) -> List[QueryTask]:
        """Batch construction of query tasks: masks the whole batch in one
        native DUST call (threads) instead of per-query."""
        params = self.params
        strands = 2 if params.opt_strand else 1
        raw: List[bytes] = []
        for rec in recs:
            raw.append(rec.sequence)
            if strands == 2:
                raw.append(maps.reverse_complement(rec.sequence))
        if params.opt_qmask == Masking.dust:
            masked = mask_mod.dust_mask_batch(raw, params.opt_hardmask)
        elif params.opt_qmask == Masking.soft and params.opt_hardmask:
            masked = [mask_mod.hardmask(s) for s in raw]
        else:
            masked = raw
        tasks = []
        for i, rec in enumerate(recs):
            seqs = list(masked[i * strands:(i + 1) * strands])
            tasks.append(QueryTask(rec.header, rec.abundance, rec.seqno,
                                   seqs, [None] * strands))
        return tasks

    def search_tasks_begin(self, tasks: List[QueryTask]):
        """Host prep + async candidate dispatch for a batch of tasks.

        Returns an opaque state consumed by search_tasks_finish; the
        device top-k runs while the caller does other (host) work —
        the 1-deep pipeline that hides output writing behind device
        compute."""
        params = self.params
        units = []  # (task, strand, QueryInfo)
        kmer_lists = []
        with phase("prep"):
            for task in tasks:
                for strand, seq in enumerate(task.seqs):
                    qi = QueryInfo(query_head=task.query_head, qsequence=seq,
                                   qseqlen=len(seq), qsize=task.qsize,
                                   strand=strand, query_no=task.query_no)
                    kmers = kmer_ops.unique_kmer_set(
                        seq, self.index.wordlength, params.opt_qmask)
                    qi.kmersamplecount = int(kmers.size)
                    units.append((task, strand, qi))
                    kmer_lists.append(kmers)
        pending = None
        prefetch = None
        bundled = None
        if self.device_index is not None:
            with phase("dispatch"):
                pending = self.device_index.topk_dispatch(kmer_lists,
                                                          self.tophits)
                prefetch = self._prefetch_dispatch(units, pending)
                # start the device->host copies now: they overlap the
                # previous batch's walk/emit
                from ..ops.bundle import bundle_fetch
                bundled = bundle_fetch(pending[1], prefetch)
        return tasks, units, kmer_lists, pending, prefetch, bundled

    # -- top-1 prefetch ---------------------------------------------------

    PREFETCH_MAXLEN = 4096  # beyond this the speculative DP costs too much

    def _prefetch_dispatch(self, units, pending):
        """Speculatively align every query against its top-1 candidate,
        chained device-to-device off the top-k output (no host sync).

        The first walk round requests exactly one target per query
        (QueryWalk.batch_limit starts at 1), and that target is the top-1
        candidate whenever it passes the unaligned gates — so in the common
        case (high --id, small maxaccepts) this removes the entire first
        alignment round, the dominant device round-trip of the search."""
        di = self.device_index
        if (di.db_codes is None or self.scheme.force_scalar_fallback
                or not pending[1]
                or di.db_codes_width > self.PREFETCH_MAXLEN):
            return None
        N = di.db_codes_width
        handles = []
        lo = 0
        for cnt, (vals, idx) in pending[1]:
            qseqs = [units[lo + i][2].qsequence for i in range(cnt)]
            lo += cnt
            maxq = max((len(s) for s in qseqs), default=0)
            if maxq == 0 or maxq > self.PREFETCH_MAXLEN:
                handles.append(None)
                continue
            handles.append(self.aligner.dispatch_indexed(
                qseqs, idx.shape[0], idx[:, 0], di.db_codes,
                di.tlen_by_pos_dev, N))
        return handles

    def _prefetch_table(self, chunks, pref_h, idx, units) -> dict:
        """unit index -> (seqno, AlignmentResult | None, overflow) for every
        fetched prefetch row whose top-1 position is a real DB entry.

        Eligible rows (SIMD-engine envelope, no overflow) are assembled
        in ONE threaded native call per chunk instead of lazily per walk."""
        if pref_h is None or idx.shape[1] == 0:
            return {}
        di = self.device_index
        table = {}
        lo = 0
        for (cnt, _), pref in zip(chunks, pref_h):
            if pref is not None:
                score, overflow, ops = pref
                batch_w, batch_cols, batch_q, batch_t = [], [], [], []
                for i in range(cnt):
                    p = int(idx[lo + i, 0])
                    if p >= di.n:
                        continue
                    w = lo + i
                    seqno = int(di.seqno_by_pos[p])
                    qseq = units[w][2].qsequence
                    tseq = self.db.getsequence(seqno)
                    if (not fits_simd(len(qseq), len(tseq))
                            or len(qseq) == 0 or len(tseq) == 0):
                        continue
                    if overflow[i]:
                        table[w] = (seqno, None, True)
                        continue
                    table[w] = (seqno, int(score[i]), False)
                    batch_w.append(w)
                    batch_cols.append(i)
                    batch_q.append(qseq)
                    batch_t.append(tseq)
                if batch_w:
                    from .. import native
                    res = native.assemble_batch(
                        np.asarray(ops), batch_cols, batch_q, batch_t,
                        self.scheme.n_mismatch)
                    if res is not None:
                        for w, (cigar, aligned, matches, mism, gaps), q \
                                in zip(batch_w, res, batch_q):
                            seqno, score_w, _ = table[w]
                            table[w] = (seqno, AlignmentResult(
                                score_w, cigar, aligned, matches, mism,
                                gaps), False)
                    else:
                        for w, col, q, t in zip(batch_w, batch_cols,
                                                batch_q, batch_t):
                            seqno, score_w, _ = table[w]
                            table[w] = (seqno, self.aligner.assemble_one(
                                score_w, np.asarray(ops)[:, col], q, t),
                                False)
            lo += cnt
        return table

    def _consume_prefetch(self, prefetched: dict, w: int, t: int,
                          qseq: bytes) -> Optional[AlignmentResult]:
        """Return the prefetched alignment for walk w / target t if the
        speculative row matches and the pair is SIMD-engine eligible
        (the same routing align_pairs applies), else None."""
        entry = prefetched.get(w)
        if entry is None or entry[0] != t:
            return None
        seqno, res, overflow = entry
        del prefetched[w]
        if overflow:
            # sentinel: same linear-memory fallback as align_pairs
            from ..ops.linmem import linmem_align
            return linmem_align(self.scheme, qseq,
                                self.db.getsequence(t))
        return res

    def search_tasks_finish(self, state) -> None:
        tasks, units, kmer_lists, pending, prefetch, bundled = state
        params = self.params
        prefetched: dict = {}
        if pending is not None:
            # wait for the copies started at dispatch (ops/bundle.py)
            q, chunks = pending
            with phase("topk_fetch"):
                from ..ops.bundle import unbundle_fetch
                topk_h, pref_h = unbundle_fetch(bundled)
            if chunks:
                vals = np.concatenate(
                    [np.asarray(v)[:nq]
                     for (nq, _), (v, _) in zip(chunks, topk_h)])
                idx = np.concatenate(
                    [np.asarray(i)[:nq]
                     for (nq, _), (_, i) in zip(chunks, topk_h)])
            else:
                vals = np.zeros((q, 0), dtype=np.int32)
                idx = np.zeros((q, 0), dtype=np.int32)
            cand_lists = self._candidates_from_topk(
                vals, idx, [qi.kmersamplecount for (_, _, qi) in units])
            with phase("prefetch"):
                prefetched = self._prefetch_table(chunks, pref_h, idx, units)
        else:
            with phase("host_topk"):
                cand_lists = self._candidates_batch(
                    kmer_lists, [qi.kmersamplecount for (_, _, qi) in units])
        with phase("walk"):
            self._run_walks(units, cand_lists, prefetched)
        for (task, strand, qi), walk in zip(units, self._last_walks):
            task.hits[strand] = walk.hits

    def _run_walks(self, units, cand_lists, prefetched) -> None:
        params = self.params
        walks: List[QueryWalk] = []
        for (task, strand, qi), candidates in zip(units, cand_lists):
            walks.append(QueryWalk(params, qi, self.db, candidates))
        self._last_walks = walks

        # lockstep alignment rounds over all walks
        active = list(range(len(walks)))
        while active:
            pair_list: List[Tuple[bytes, int]] = []
            owners: List[Tuple[int, int]] = []  # (walk idx, target)
            pre_results: Dict[Tuple[int, int], AlignmentResult] = {}
            any_request = False
            for w in active:
                targets = walks[w].advance()
                if targets:
                    any_request = True
                    for t in targets:
                        res = self._consume_prefetch(
                            prefetched, w, t,
                            walks[w].qi.qsequence) if prefetched else None
                        if res is not None:
                            pre_results[(w, t)] = res
                        else:
                            pair_list.append((walks[w].qi.qsequence, t))
                            owners.append((w, t))
            if not any_request:
                break
            results = self.align_pairs(pair_list) if pair_list else []
            per_walk: Dict[int, Dict[int, AlignmentResult]] = {}
            for (w, t), res in zip(owners, results):
                per_walk.setdefault(w, {})[t] = res
            for (w, t), res in pre_results.items():
                per_walk.setdefault(w, {})[t] = res
            next_active = []
            for w in active:
                if w in per_walk:
                    walks[w].supply(per_walk[w])
                if not walks[w].done:
                    next_active.append(w)
            active = next_active

    def join_task(self, task: QueryTask) -> List[Hit]:
        return join_hits(self.params, task.hits[0],
                         task.hits[1] if len(task.hits) > 1 else None)
