"""allpairs_global command: all-vs-all pairwise global alignment.

reference: src/commands/allpairs_global.cpp — each query i aligned against
every target i+1..n-1 (no k-mer index), accepted hits sorted by
(id desc, target asc); forced single strand.

Device stats pipeline (ops/allpairs_dev.py): the sequence codes upload
once, the triangular schedule runs as index-pair batches through the
forward with the match plane (K2m) and the stats walk (K5), the per-pair
STATISTICS (8 ints and an overflow flag) come back in one copy, the
accept/reject cascade runs vectorized on host, and only accepted hits are
aligned again for their CIGARs.  It runs on the port's device, the CUDA
card or, asked for, the CPU (the kernels' plain versions).  The generic
path, which aligns every pair through the batched aligner, takes
--acceptall (every pair is emitted, so per-pair CIGARs are needed anyway),
infinite gap penalties, fewer than 16 sequences and lengths outside
1..2048.
"""

from __future__ import annotations

from contextlib import ExitStack
from typing import List, Optional

import numpy as np

from ..params import Masking, Parameters
from ..db import Database
from ..io import fastx as fastx_io
from ..core import mask as mask_mod
from ..core import results
from ..core.search import SearchContext
from ..core.searchcore import (Hit, QueryInfo, align_trim,
                               fill_alignment_fields,
                               search_acceptable_aligned,
                               search_acceptable_unaligned,
                               unaligned_gate_active)
from ..utils.phasetimer import phase


from ..io.openfile import open_output_opt as _open  # noqa: E402


def _accept_mask(eff: Parameters, stats: np.ndarray, qlens: np.ndarray,
                 tlens: np.ndarray) -> np.ndarray:
    """Vectorized search_acceptable_aligned (searchcore.cpp:664-737) over
    device stats rows [aligned, matches, indels, gap_opens, first_op,
    first_len, last_op, last_len]; float math is IEEE double in the same
    expression order as the scalar path, so the mask is exact."""
    aligned = stats[:, 0].astype(np.float64)
    matches = stats[:, 1].astype(np.int64)
    indels = stats[:, 2].astype(np.int64)
    gap_opens = stats[:, 3].astype(np.int64)
    first_op = stats[:, 4]
    first_len = stats[:, 5].astype(np.int64)
    last_op = stats[:, 6]
    last_len = stats[:, 7].astype(np.int64)

    nwalnlen = stats[:, 0].astype(np.int64)
    mism = nwalnlen - matches - indels

    tql = np.where(first_op == 2, first_len, 0)
    ttl = np.where(first_op == 3, first_len, 0)
    tqr = np.where(last_op == 2, last_len, 0)
    ttr = np.where(last_op == 3, last_len, 0)
    tqr = np.where(tql >= nwalnlen, 0, tqr)
    ttr = np.where(ttl >= nwalnlen, 0, ttr)

    int_alnlen = nwalnlen - tql - ttl - tqr - ttr
    int_indels = indels - tql - ttl - tqr - ttr
    int_gaps = (gap_opens - (tql + ttl > 0).astype(np.int64)
                - (tqr + ttr > 0).astype(np.int64))

    shortest = np.minimum(qlens, tlens).astype(np.float64)
    longest = np.maximum(qlens, tlens).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        id0 = np.where(shortest > 0, 100.0 * matches / shortest, 0.0)
        id1 = np.where(nwalnlen > 0, 100.0 * matches / aligned, 0.0)
        id2 = np.where(int_alnlen > 0,
                       100.0 * matches / int_alnlen.astype(np.float64), 0.0)
        id3 = np.maximum(
            0.0, 100.0 * (1.0 - (1.0 * (mism + gap_opens) / longest)))
        mid_frac = 100.0 * matches / (matches + mism).astype(np.float64)
    ids = [id0, id1, id2, id3, id1][eff.opt_iddef]

    ok = ((ids >= 100.0 * eff.opt_weak_id)
          & (mism <= eff.opt_maxsubs)
          & (int_gaps <= eff.opt_maxgaps)
          & (int_alnlen >= eff.opt_mincols)
          & ((eff.opt_leftjust == 0) | (tql + ttl == 0))
          & ((eff.opt_rightjust == 0) | (tqr + ttr == 0))
          & (matches + mism >= eff.opt_query_cov * qlens)
          & (matches + mism >= eff.opt_target_cov
             * tlens.astype(np.float64))
          & (ids <= 100.0 * eff.opt_maxid)
          & (mid_frac >= eff.opt_mid)
          & (mism + int_indels <= eff.opt_maxdiffs)
          & (ids >= 100.0 * eff.opt_id))
    return ok


def allpairs_global(params: Parameters) -> None:
    with ExitStack() as stack:
        fp_alnout = _open(stack, params.opt_alnout, "--alnout")
        if fp_alnout is not None:
            fp_alnout.write(params.command_line.encode() + b"\n")
            fp_alnout.write(params.prog_header.encode() + b"\n")
        fp_samout = _open(stack, params.opt_samout, "--samout")
        fp_userout = _open(stack, params.opt_userout, "--userout")
        fp_blast6out = _open(stack, params.opt_blast6out, "--blast6out")
        fp_uc = _open(stack, params.opt_uc, "--uc")
        fp_fastapairs = _open(stack, params.opt_fastapairs, "--fastapairs")
        fp_qsegout = _open(stack, params.opt_qsegout, "--qsegout")
        fp_tsegout = _open(stack, params.opt_tsegout, "--tsegout")
        fp_matched = _open(stack, params.opt_matched, "--matched")
        fp_notmatched = _open(stack, params.opt_notmatched, "--notmatched")

        db = Database()
        db.read(params.opt_allpairs_global, params)
        if fp_samout is not None:
            results.show_samheader(fp_samout, params, params.opt_allpairs_global, db)
        if params.opt_qmask == Masking.dust:
            mask_mod.dust_all(db, params)
        elif params.opt_qmask == Masking.soft and params.opt_hardmask:
            mask_mod.hardmask_all(db)

        from ..index import KmerIndex
        ctx = SearchContext.build(params, db, index=KmerIndex(
            params.opt_wordlength))
        eff = ctx.params

        state = {"qmatches": 0, "matched": 0, "notmatched": 0}
        seqcount = db.seqcount

        def emit_query(qi: QueryInfo, finalhits: List[Hit]) -> None:
            toreport = min(params.opt_maxhits, len(finalhits))
            hits = finalhits
            query_head = qi.query_head
            qseqlen = qi.qseqlen
            qseq = qi.qsequence

            if fp_alnout is not None:
                results.show_alnout(fp_alnout, params, hits[:toreport],
                                    query_head, qseq, qseqlen, db)
            if fp_samout is not None:
                results.show_samout(fp_samout, params, hits[:toreport],
                                    query_head, qseq, None, db)
            if toreport:
                top_hit_id = hits[0].id
                for t in range(toreport):
                    hp = hits[t]
                    if params.opt_top_hits_only and hp.id < top_hit_id:
                        break
                    if fp_fastapairs is not None:
                        results.show_fastapairs_one(fp_fastapairs, params,
                                                    hp, query_head, qseq,
                                                    None, db)
                    if fp_qsegout is not None:
                        results.show_qsegout_one(fp_qsegout, params, hp,
                                                 query_head, qseq, qseqlen,
                                                 None)
                    if fp_tsegout is not None:
                        results.show_tsegout_one(fp_tsegout, params, hp, db)
                    if fp_uc is not None and (t == 0
                                              or params.opt_uc_allhits):
                        results.show_uc_one(fp_uc, params, hp, query_head,
                                            qseqlen, hp.target, db)
                    if fp_userout is not None:
                        results.show_userout_one(fp_userout, params, hp,
                                                 query_head, qseq, qseqlen,
                                                 None, db)
                    if fp_blast6out is not None:
                        results.show_blast6_one(fp_blast6out, params, hp,
                                                query_head, qseqlen, db)
            else:
                if fp_uc is not None:
                    results.show_uc_one(fp_uc, params, None, query_head,
                                        qseqlen, 0, db)
                if params.opt_output_no_hits:
                    if fp_userout is not None:
                        results.show_userout_one(fp_userout, params, None,
                                                 query_head, qseq, qseqlen,
                                                 None, db)
                    if fp_blast6out is not None:
                        results.show_blast6_one(fp_blast6out, params, None,
                                                query_head, qseqlen, db)

            if hits:
                state["qmatches"] += 1
                state["matched"] += 1
                if fp_matched is not None:
                    fastx_io.fasta_print_general(fp_matched, params, qseq,
                                                 query_head, qi.qsize,
                                                 state["matched"])
            else:
                state["notmatched"] += 1
                if fp_notmatched is not None:
                    fastx_io.fasta_print_general(fp_notmatched, params,
                                                 qseq, query_head, qi.qsize,
                                                 state["notmatched"])

        def make_qi(query_no: int) -> QueryInfo:
            return QueryInfo(query_head=db.getheader(query_no),
                             qsequence=db.getsequence(query_no),
                             qseqlen=db.getsequencelen(query_no),
                             qsize=db.getabundance(query_no), strand=0,
                             query_no=query_no)

        def build_hit(qi: QueryInfo, t: int, res) -> Optional[Hit]:
            hit = Hit(target=t, strand=0, count=0)
            fill_alignment_fields(hit, qi, db, res)
            align_trim(hit, eff)
            if params.opt_acceptall or \
                    search_acceptable_aligned(eff, qi, db, hit):
                return hit
            return None

        from ..utils.progress import Progress
        align_progress = Progress(
            "Aligning", max(0, seqcount * (seqcount - 1)) // 2, params)

        maxlen = max((db.getsequencelen(i) for i in range(seqcount)),
                     default=0)
        use_fast = (
            not params.opt_acceptall
            and not eff.opt_gap_penalty_has_infinite
            and seqcount >= 16
            and 0 < maxlen <= 2048
            and min(db.getsequencelen(i) for i in range(seqcount)) > 0)

        if use_fast:
            _allpairs_fast(params, eff, db, ctx, align_progress, make_qi,
                           build_hit, emit_query)
        else:
            _allpairs_generic(params, eff, db, ctx, align_progress,
                              make_qi, build_hit, emit_query)

        align_progress.done()
        # reference: allpairs_global.cpp:656-677 — "Matching query
        # sequences" (no "unique"); the log copy gets an extra blank line
        from ..utils.progress import message
        msg = "Matching query sequences: %d of %d" % (state["qmatches"],
                                                      seqcount)
        if seqcount > 0:
            msg += " (%.2f%%)" % (100.0 * state["qmatches"] / seqcount)
        message(params, msg)


def _targets_for(params, eff, db, qi, seqcount):
    if params.opt_acceptall or not unaligned_gate_active(eff):
        return list(range(qi.query_no + 1, seqcount))
    return [t for t in range(qi.query_no + 1, seqcount)
            if search_acceptable_unaligned(eff, qi, db, t)]


def _allpairs_generic(params, eff, db, ctx, align_progress, make_qi,
                      build_hit, emit_query) -> None:
    """Generic batched-aligner path (host C tier / non-TPU backends)."""
    seqcount = db.seqcount
    BATCH_PAIRS = 8192

    def query_groups():
        pending = []       # (qi, targets)
        pairs = []
        for query_no in range(seqcount):
            align_progress.update(align_progress._counter
                                  + (seqcount - query_no - 1))
            qi = make_qi(query_no)
            targets = _targets_for(params, eff, db, qi, seqcount)
            pending.append((qi, targets))
            pairs.extend((qi.qsequence, t) for t in targets)
            if len(pairs) >= BATCH_PAIRS:
                yield pending, ctx.align_pairs(pairs)
                pending = []
                pairs = []
        if pending:
            yield pending, ctx.align_pairs(pairs)

    for pending, aligned in query_groups():
        cursor = 0
        for qi, targets in pending:
            finalhits = []
            if targets:
                for t, res in zip(targets,
                                  aligned[cursor:cursor + len(targets)]):
                    hit = build_hit(qi, t, res)
                    if hit is not None:
                        finalhits.append(hit)
                cursor += len(targets)
                finalhits.sort(key=lambda h: (-h.id, h.target))
            emit_query(qi, finalhits)


def _allpairs_fast(params, eff, db, ctx, align_progress, make_qi,
                   build_hit, emit_query) -> None:
    """Device stats pipeline: the whole triangle through K2m and K5, one
    fetch, vectorized accept, realign only accepted/overflow pairs."""
    from .. import device as device_mod
    from ..ops.allpairs_dev import AllPairsDevice
    seqcount = db.seqcount
    seqs = [db.getsequence(i) for i in range(seqcount)]
    dev = AllPairsDevice(ctx.scheme, seqs, device_mod.current())
    lens = np.fromiter((db.getsequencelen(i) for i in range(seqcount)),
                       dtype=np.int64, count=seqcount)

    # the triangle in (q asc, t asc) order
    qis = {}
    if unaligned_gate_active(eff):
        qs: List[int] = []
        ts: List[int] = []
        for q in range(seqcount):
            align_progress.update(align_progress._counter
                                  + (seqcount - q - 1))
            qi = qis.setdefault(q, make_qi(q))
            targets = _targets_for(params, eff, db, qi, seqcount)
            qs.extend([q] * len(targets))
            ts.extend(targets)
        qpos = np.asarray(qs, dtype=np.int64)
        tpos = np.asarray(ts, dtype=np.int64)
    else:
        qpos, tpos = np.triu_indices(seqcount, 1)
        align_progress.update(align_progress._counter + qpos.size)

    overflow, stats = dev.run(qpos, tpos)

    # vectorized acceptance over the whole triangle
    with phase("accept"):
        ok = _accept_mask(eff, stats, lens[qpos], lens[tpos]) & ~overflow
    accepted = {}        # query_no -> list of target
    for q, t in zip(qpos[ok].tolist(), tpos[ok].tolist()):
        accepted.setdefault(q, []).append(t)

    # overflow pairs: exact scalar path decides (sentinel -> linmem)
    slow = list(zip(qpos[overflow].tolist(), tpos[overflow].tolist()))
    slow_results = {}
    if slow:
        res = ctx.align_pairs([(seqs[q], t) for q, t in slow])
        for (q, t), r in zip(slow, res):
            if build_hit(qis.setdefault(q, make_qi(q)), t, r) is not None:
                accepted.setdefault(q, []).append(t)
                slow_results[(q, t)] = r

    # realign accepted pairs for CIGARs (rare), then emit in query order
    pending = [(q, t) for q in sorted(accepted) for t in accepted[q]
               if (q, t) not in slow_results]
    results_map = dict(slow_results)
    if pending:
        res = ctx.align_pairs([(seqs[q], t) for q, t in pending])
        results_map.update(zip(pending, res))
    with phase("emit"):
        for q in range(seqcount):
            qi = qis.get(q) or make_qi(q)
            finalhits = []
            for t in accepted.get(q, ()):
                hit = build_hit(qi, t, results_map[(q, t)])
                if hit is not None:
                    finalhits.append(hit)
            finalhits.sort(key=lambda h: (-h.id, h.target))
            emit_query(qi, finalhits)
