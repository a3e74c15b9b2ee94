"""allpairs_global command: all-vs-all pairwise global alignment.

reference: src/commands/allpairs_global.cpp — each query i aligned against
every target i+1..n-1 (no k-mer index), accepted hits sorted by
(id desc, target asc); forced single strand.

Device stats pipeline (ops/allpairs_dev.py): the sequence codes upload
once, the triangular schedule runs as index-pair batches through the
forward with the match plane (K2m) and the stats walk (K5), the
accept/reject cascade runs over the per-pair statistics where they are
(accept_mask), and only a byte a pair of its verdict and of the overflow
flag comes back; only the accepted and the overflowing pairs are aligned
again, for their CIGARs.  The triangle runs in chunks of batches: a
chunk's pairs are aligned again and the queries it completes written
while the card runs the next chunks.  It runs on the port's device, the
CUDA card or, asked for, the CPU (the kernels' plain versions).  The generic
path, which aligns every pair through the batched aligner, takes
--acceptall (every pair is emitted, so per-pair CIGARs are needed anyway),
infinite gap penalties, fewer than 16 sequences and lengths outside
1..2048.
"""

from __future__ import annotations

from collections import deque
from contextlib import ExitStack
from functools import partial
from typing import List, Optional

import numpy as np
import torch

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
from ..utils.phasetimer import add, phase


from ..io.openfile import open_output_opt as _open  # noqa: E402


def accept_mask(eff: Parameters, stats: torch.Tensor, qlens: torch.Tensor,
                tlens: torch.Tensor) -> torch.Tensor:
    """search_acceptable_aligned (searchcore.cpp:664-737) over stats rows
    [aligned, matches, indels, gap_opens, first_op, first_len, last_op,
    last_len] and the pairs' lengths, on the tensors' device: a (P,) bool
    mask.  Counts are int64 and the float math IEEE double in the scalar
    path's expression order, one eager op at a time (nothing fused, so no
    rounding is contracted or reordered), so the mask is exact on either
    device.  Python floats multiply float64 tensors only (times an integer
    tensor torch computes in float32), and every divisor is a tensor (the
    card divides by a Python scalar as a product by its reciprocal).  A
    0/0 identity is NaN, which every comparison rejects."""
    i64, f64 = torch.int64, torch.float64
    (nwalnlen, matches, indels, gap_opens, first_op, first_len, last_op,
     last_len) = stats.to(i64).unbind(1)
    mism = nwalnlen - matches - indels

    tql = torch.where(first_op == 2, first_len, 0)
    ttl = torch.where(first_op == 3, first_len, 0)
    tqr = torch.where(last_op == 2, last_len, 0)
    ttr = torch.where(last_op == 3, last_len, 0)
    tqr = torch.where(tql >= nwalnlen, 0, tqr)
    ttr = torch.where(ttl >= nwalnlen, 0, ttr)

    int_alnlen = nwalnlen - tql - ttl - tqr - ttr
    int_indels = indels - tql - ttl - tqr - ttr
    int_gaps = (gap_opens - (tql + ttl > 0).to(i64)
                - (tqr + ttr > 0).to(i64))

    qf, tf = qlens.to(f64), tlens.to(f64)
    m100 = 100.0 * matches.to(f64)
    if eff.opt_iddef == 0:
        shortest = torch.minimum(qf, tf)
        ids = torch.where(shortest > 0, m100 / shortest, 0.0)
    elif eff.opt_iddef == 2:
        ids = torch.where(int_alnlen > 0, m100 / int_alnlen.to(f64), 0.0)
    elif eff.opt_iddef == 3:
        longest = torch.maximum(qf, tf)
        ids = torch.maximum(
            qf.new_zeros(()),
            100.0 * (1.0 - (mism + gap_opens).to(f64) / longest))
    else:   # 1 and 4
        ids = torch.where(nwalnlen > 0, m100 / nwalnlen.to(f64), 0.0)
    mid_frac = m100 / (matches + mism).to(f64)

    ok = ((ids >= 100.0 * eff.opt_weak_id)
          & (mism <= eff.opt_maxsubs)
          & (int_gaps <= eff.opt_maxgaps)
          & (int_alnlen >= eff.opt_mincols)
          & (matches + mism >= qf * eff.opt_query_cov)
          & (matches + mism >= tf * eff.opt_target_cov)
          & (ids <= 100.0 * eff.opt_maxid)
          & (mid_frac >= eff.opt_mid)
          & (mism + int_indels <= eff.opt_maxdiffs)
          & (ids >= 100.0 * eff.opt_id))
    if eff.opt_leftjust:
        ok &= tql + ttl == 0
    if eff.opt_rightjust:
        ok &= tqr + ttr == 0
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
        with phase("read"):
            db.read(params.opt_allpairs_global, params)
        if fp_samout is not None:
            results.show_samheader(fp_samout, params, params.opt_allpairs_global, db)
        with phase("mask"):
            if params.opt_qmask == Masking.dust:
                mask_mod.dust_all(db, params)
            elif params.opt_qmask == Masking.soft and params.opt_hardmask:
                mask_mod.hardmask_all(db)

        from ..index import KmerIndex
        with phase("context"):
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
                written = 0
                for t in range(toreport):
                    hp = hits[t]
                    if params.opt_top_hits_only and hp.id < top_hit_id:
                        break
                    written += 1
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
                add("allpairs.rows", written)
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
        # the buffered outputs flushed and closed
        with phase("close"):
            stack.close()


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
    """Device stats pipeline: the triangle through K2m, K5 and the accept
    on the device in chunks of batches (AllPairsDevice.chunks), two
    queued ahead of the one taken; as each chunk's accepted and overflow
    pairs' indices arrive, those pairs are realigned and the queries the
    chunk completes are written, while the card runs the next chunks."""
    from .. import device as device_mod
    from ..ops.allpairs_dev import AllPairsDevice, take_rows
    seqcount = db.seqcount
    seqs = [db.getsequence(i) for i in range(seqcount)]
    with phase("upload"):
        dev = AllPairsDevice(ctx.scheme, seqs, device_mod.current())

    # the triangle in (q asc, t asc) order, on the host and on the device
    qis = {}
    with phase("triangle"):
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
        qpos_d, tpos_d = (torch.from_numpy(a).to(dev.device)
                          for a in (qpos, tpos))

    accepted = {}        # query_no -> targets, until the query is written
    results_map = {}     # (query_no, target) -> its realign
    written = 0          # the queries before it are written

    def emit_until(upto: int) -> None:
        nonlocal written
        with phase("emit"):
            for q in range(written, upto):
                qi = qis.pop(q, None) or make_qi(q)
                finalhits = []
                for t in accepted.pop(q, ()):
                    hit = build_hit(qi, t, results_map.pop((q, t)))
                    if hit is not None:
                        finalhits.append(hit)
                finalhits.sort(key=lambda h: (-h.id, h.target))
                emit_query(qi, finalhits)
        written = upto

    def finish(hi, slow, pending, realign) -> None:
        """A chunk's realign taken: its overflow pairs decided by the
        exact scalar path (sentinel -> linmem), and the queries whose
        pairs all lie in the chunks up to it written (those before the
        next chunk's first query, or all of them after the last)."""
        res = ctx.align_pairs_end(realign) if realign else []
        with phase("collect"):
            for (q, t), r in zip(slow, res):
                qi = qis.setdefault(q, make_qi(q))
                if build_hit(qi, t, r) is not None:
                    accepted.setdefault(q, []).append(t)
                    results_map[(q, t)] = r
            results_map.update(zip(pending, res[len(slow):]))
        emit_until(int(qpos[hi]) if hi < qpos.size else seqcount)

    # Chunk k's pairs are realigned on the card's stream behind chunk
    # k + 1, ahead of chunk k + 2, so K2 and K3 run between K2m launches
    # at the card's full width, and their fetch, after chunk k + 2 is
    # queued, waits for them alone; its host work (the overflow pairs'
    # decision, the writers) then runs while the card runs chunk k + 2.
    bounds = dev.chunks(qpos.size)
    accept = partial(accept_mask, eff)
    ahead = deque(dev.queue_chunk(qpos_d, tpos_d, lo, hi, accept)
                  for lo, hi in bounds[:2])
    taken = None
    for k, (_, hi) in enumerate(bounds):
        ok_rows, over_rows = take_rows(ahead.popleft())
        with phase("collect"):
            pending = list(zip(qpos[ok_rows].tolist(),
                               tpos[ok_rows].tolist()))
            for q, t in pending:
                accepted.setdefault(q, []).append(t)
            slow = list(zip(qpos[over_rows].tolist(),
                            tpos[over_rows].tolist()))
            add("allpairs.accepted", len(pending))
            add("allpairs.overflow", len(slow))
            add("allpairs.realigned", len(slow) + len(pending))
        realign = (ctx.align_pairs_begin([(seqs[q], t)
                                          for q, t in slow + pending])
                   if slow or pending else None)
        if k + 2 < len(bounds):
            ahead.append(dev.queue_chunk(qpos_d, tpos_d, *bounds[k + 2],
                                         accept))
        if taken is not None:
            finish(*taken)
        taken = hi, slow, pending, realign
    if taken is not None:
        finish(*taken)
    emit_until(seqcount)
