"""uchime_denovo / uchime2_denovo / uchime3_denovo / uchime_ref commands.

reference: src/core/chimera.cpp chimera() (:2426-2770) + the output blocks
of eval_parents (:1697-1886) and chimera_thread_core (:2248-2394).
Counterpart of vsearch_tpu/commands/chimera.py.
"""

from __future__ import annotations

import sys
from contextlib import ExitStack
from typing import IO, Optional

from ..params import Masking, Parameters
from ..db import Database
from ..index import KmerIndex
from ..io import fastx as fastx_io
from ..io.attributes import header_strip
from ..core import mask as mask_mod
from ..core.chimera import (ChimeraEngine, ChimeraResult, Status,
                            detection_parameters)
from ..core.search import SearchContext
from ..utils.phasetimer import phase as timed_phase


from ..io.openfile import open_output_opt as _open  # noqa: E402

# host-tier round width.  A pure performance knob: the exact same-round
# repair makes the output identical for any round size (the reference's
# --threads scaling relies on the same property).  Once the growing device
# index is active a round is DEVICE_ROUND queries: four of K4's 512-query
# chunks in one dispatch, the parts of a query being four.
ROUND_SIZE = 128
DEVICE_ROUND = 512


def _strip(params: Parameters, header: bytes) -> bytes:
    stripped, _ = header_strip(header, params.opt_xsize, params.opt_xee,
                               params.opt_xlength)
    return stripped


def _write_uchimeout_hit(out, params: Parameters, res: ChimeraResult,
                         query_head: bytes, db) -> None:
    """reference: eval_parents uchimeout block (:1809-1878)."""
    out.write(b"%.4f\t" % res.best_h)
    out.write(_strip(params, query_head))
    out.write(b"\t")
    out.write(_strip(params, db.getheader(res.seqno_a)))
    out.write(b"\t")
    out.write(_strip(params, db.getheader(res.seqno_b)))
    out.write(b"\t")
    if params.opt_uchimeout5 == 0:
        if res.QA >= res.QB:
            out.write(_strip(params, db.getheader(res.seqno_a)))
        else:
            out.write(_strip(params, db.getheader(res.seqno_b)))
        out.write(b"\t")
    flag = b"Y" if res.status == Status.chimeric else (
        b"N" if res.status == Status.low_score else b"?")
    out.write(b"%.1f\t%.1f\t%.1f\t%.1f\t%.1f\t%d\t%d\t%d\t%d\t%d\t%d\t%.1f\t%s\n"
              % (res.QM, res.QA, res.QB, res.AB, res.QT,
                 res.best_left_y, res.best_left_n, res.best_left_a,
                 res.best_right_y, res.best_right_n, res.best_right_a,
                 res.divdiff, flag))


def _write_uchimeout_nohit(out, params: Parameters, best_h: float,
                           query_head: bytes) -> None:
    """reference: chimera_thread_core no-parents row (:2301-2322)."""
    out.write(b"%.4f\t" % best_h)
    out.write(_strip(params, query_head))
    if params.opt_uchimeout5 != 0:
        out.write(b"\t*\t*\t*\t*\t*\t*\t*\t0\t0\t0\t0\t0\t0\t*\tN\n")
    else:
        out.write(b"\t*\t*\t*\t*\t*\t*\t*\t*\t0\t0\t0\t0\t0\t0\t*\tN\n")


def _write_uchimealns(out, params: Parameters, res: ChimeraResult,
                      query_head: bytes, query_len: int, db) -> None:
    """reference: eval_parents uchimealns block (:1697-1806)."""
    out.write(b"\n")
    out.write(b"-" * 72 + b"\n")
    out.write(b"Query   (%5d nt) " % query_len)
    out.write(_strip(params, query_head))
    out.write(b"\nParentA (%5d nt) " % db.getsequencelen(res.seqno_a))
    out.write(_strip(params, db.getheader(res.seqno_a)))
    out.write(b"\nParentB (%5d nt) " % db.getsequencelen(res.seqno_b))
    out.write(_strip(params, db.getheader(res.seqno_b)))
    out.write(b"\n\n")

    alnlen = len(res.qaln)
    width = params.opt_alignwidth if params.opt_alignwidth > 0 else alnlen
    qpos = p1pos = p2pos = 0
    for i in range(0, alnlen, width):
        w = min(alnlen - i, width)
        qline = res.qaln[i:i + w]
        aline = res.paln_a[i:i + w]
        bline = res.paln_b[i:i + w]
        qnt = w - qline.count(b"-")
        ant = w - aline.count(b"-")
        bnt = w - bline.count(b"-")
        out.write(b"A %5d %s %d\n" % (p1pos + 1, aline, p1pos + ant))
        out.write(b"Q %5d %s %d\n" % (qpos + 1, qline, qpos + qnt))
        out.write(b"B %5d %s %d\n" % (p2pos + 1, bline, p2pos + bnt))
        out.write(b"Diffs   %s\n" % res.diffs[i:i + w])
        out.write(b"Votes   %s\n" % res.votes[i:i + w])
        out.write(b"Model   %s\n" % res.model[i:i + w])
        out.write(b"\n")
        qpos += qnt
        p1pos += ant
        p2pos += bnt

    sumL = res.best_left_n + res.best_left_a + res.best_left_y
    sumR = res.best_right_n + res.best_right_a + res.best_right_y
    out.write(b"Ids.  QA %.1f%%, QB %.1f%%, AB %.1f%%, QModel %.1f%%, "
              b"Div. %+.1f%%\n" % (res.QA, res.QB, res.AB, res.QM,
                                   res.divfrac))
    out.write(b"Diffs Left %d: N %d, A %d, Y %d (%.1f%%); "
              b"Right %d: N %d, A %d, Y %d (%.1f%%), Score %.4f\n" % (
                  sumL, res.best_left_n, res.best_left_a, res.best_left_y,
                  100.0 * res.best_left_y / sumL,
                  sumR, res.best_right_n, res.best_right_a, res.best_right_y,
                  100.0 * res.best_right_y / sumR, res.best_h))


def _write_long_alnout(out, params: Parameters, res, query_head: bytes,
                       query_len: int, db) -> None:
    """reference: eval_parents_long alnout block (:1095-1185)."""
    out.write(b"\n")
    out.write(b"-" * 72 + b"\n")
    out.write(b"Query   (%5d nt) " % query_len)
    out.write(_strip(params, query_head))
    for f, seqno in enumerate(res.seqnos):
        out.write(b"\nParent%c (%5d nt) " % (ord("A") + f,
                                             db.getsequencelen(seqno)))
        out.write(_strip(params, db.getheader(seqno)))
    out.write(b"\n\n")

    alnlen = len(res.qaln)
    width = params.opt_alignwidth if params.opt_alignwidth > 0 else alnlen
    qpos = 0
    ppos = [0] * len(res.seqnos)
    for i in range(0, alnlen, width):
        w = min(alnlen - i, width)
        qline = res.qaln[i:i + w]
        qnt = w - qline.count(b"-")
        out.write(b"Q %5d %s %d\n" % (qpos + 1, qline, qpos + qnt))
        for f in range(len(res.seqnos)):
            pline = res.palns[f][i:i + w]
            pnt = w - pline.count(b"-")
            out.write(b"%c %5d %s %d\n" % (ord("A") + f, ppos[f] + 1, pline,
                                           ppos[f] + pnt))
            ppos[f] += pnt
        out.write(b"Diffs   %s\n" % res.diffs[i:i + w])
        out.write(b"Model   %s\n" % res.model[i:i + w])
        out.write(b"\n")
        qpos += qnt

    QA = res.QP[0]
    QB = res.QP[1]
    QC = res.QP[2] if len(res.QP) > 2 else 0.0
    out.write(b"Ids.  QA %.2f%%, QB %.2f%%, QC %.2f%%, QT %.2f%%, "
              b"QModel %.2f%%, Div. %+.2f%%\n"
              % (QA, QB, QC, res.QT, 100.0, res.divfrac))


def _write_long_tabbedout(out, params: Parameters, res, query_head: bytes,
                          db) -> None:
    """reference: eval_parents_long tabbedout block (:1187-1243)."""
    out.write(b"%.4f\t" % 99.9999)
    out.write(_strip(params, query_head))
    out.write(b"\t")
    out.write(_strip(params, db.getheader(res.seqnos[0])))
    out.write(b"\t")
    out.write(_strip(params, db.getheader(res.seqnos[1])))
    out.write(b"\t")
    if len(res.seqnos) > 2:
        out.write(_strip(params, db.getheader(res.seqnos[2])))
    else:
        out.write(b"*")
    out.write(b"\t")
    QA = res.QP[0]
    QB = res.QP[1]
    QC = res.QP[2] if len(res.QP) > 2 else 0.0
    out.write(b"%.2f\t%.2f\t%.2f\t%.2f\t%.2f\t%d\t%d\t%d\t%d\t%d\t%d\t%.2f\t%c\n"
              % (100.0, QA, QB, QC, res.QT, 0, 0, 0, 0, 0, 0, 0.0, ord("Y")))


def chimera_command(params: Parameters, command: str) -> None:
    is_ref = command == "uchime_ref"
    is_long = command == "chimeras_denovo"
    if params.opt_strand and is_ref:
        raise ValueError("Only --strand plus is allowed with uchime_ref.")

    detection = detection_parameters(params)

    with ExitStack() as stack:
        fp_chimeras = _open(stack, params.opt_chimeras, "--chimeras")
        fp_nonchimeras = _open(stack, params.opt_nonchimeras, "--nonchimeras")
        fp_borderline = _open(stack, params.opt_borderline, "--borderline")
        # chimeras_denovo reuses the aln/tab handles for --alnout/--tabbedout
        # (chimera.cpp:2441-2453)
        if is_long:
            fp_uchimealns = _open(stack, params.opt_alnout, "--alnout")
            fp_uchimeout = _open(stack, params.opt_tabbedout, "--tabbedout")
        else:
            fp_uchimealns = _open(stack, params.opt_uchimealns, "--uchimealns")
            fp_uchimeout = _open(stack, params.opt_uchimeout, "--uchimeout")

        with timed_phase("load"):
            if is_ref:
                from ..core.search import load_db_and_index
                db, index = load_db_and_index(params, params.opt_db)
                queries = fastx_io.read_fastx(params.opt_uchime_ref, params)
            else:
                db = Database()
                index = KmerIndex(params.opt_wordlength)
                denovo_file = getattr(params, "opt_" + command)
                db.read(denovo_file, params)
                if params.opt_qmask == Masking.dust:
                    mask_mod.dust_all(db, params)
                elif params.opt_qmask == Masking.soft and params.opt_hardmask:
                    mask_mod.hardmask_all(db)
                db.sortbyabundance(params)
                from ..utils.progress import phase
                phase(params, "Counting k-mers")  # chimera.cpp:2558 prepare
                queries = None  # queries come from the db in abundance order

            ctx = SearchContext.build(detection, db, index=index)
            # chimera tophits = maxaccepts + maxrejects, no MAXDELAYED/seqcount
            # adjustment (chimera.cpp:2178-2181)
            ctx.tophits = detection.opt_maxaccepts + detection.opt_maxrejects
            engine = ChimeraEngine(params, ctx.params, db, index, ctx)

        stats = {"chimera": 0, "nonchimera": 0, "borderline": 0, "total": 0,
                 "chimera_ab": 0, "nonchimera_ab": 0, "borderline_ab": 0,
                 "total_ab": 0}

        def handle(res: ChimeraResult, query_head: bytes, query_seq: bytes,
                   query_size: int) -> None:
            stats["total"] += 1
            stats["total_ab"] += query_size

            score_name = None
            if params.opt_fasta_score:
                score_name = b"uchime_ref" if is_ref else b"uchime_denovo"

            if res.status == Status.chimeric:
                stats["chimera"] += 1
                stats["chimera_ab"] += query_size
                if is_long:
                    if fp_uchimealns is not None:
                        _write_long_alnout(fp_uchimealns, params, res,
                                           query_head, len(query_seq), db)
                    if fp_uchimeout is not None:
                        _write_long_tabbedout(fp_uchimeout, params, res,
                                              query_head, db)
                elif fp_uchimealns is not None:
                    _write_uchimealns(fp_uchimealns, params, res, query_head,
                                      len(query_seq), db)
                if not is_long and fp_uchimeout is not None:
                    _write_uchimeout_hit(fp_uchimeout, params, res,
                                         query_head, db)
                if fp_chimeras is not None:
                    fastx_io.fasta_print_general(
                        fp_chimeras, params, query_seq, query_head,
                        query_size, stats["chimera"],
                        score_name=score_name, score=res.best_h)
            elif res.status == Status.suspicious:
                stats["borderline"] += 1
                stats["borderline_ab"] += query_size
                if fp_uchimeout is not None:
                    _write_uchimeout_hit(fp_uchimeout, params, res,
                                         query_head, db)
                if fp_borderline is not None:
                    fastx_io.fasta_print_general(
                        fp_borderline, params, query_seq, query_head,
                        query_size, stats["borderline"],
                        score_name=score_name, score=res.best_h)
            else:
                stats["nonchimera"] += 1
                stats["nonchimera_ab"] += query_size
                if res.status == Status.low_score:
                    if not is_long and fp_uchimeout is not None:
                        _write_uchimeout_hit(fp_uchimeout, params, res,
                                             query_head, db)
                else:
                    # long mode never writes no-hit rows: the reference gates
                    # them on --uchimeout, not --tabbedout (:2293)
                    if not is_long and fp_uchimeout is not None:
                        _write_uchimeout_nohit(fp_uchimeout, params,
                                               res.best_h, query_head)
                if fp_nonchimeras is not None:
                    fastx_io.fasta_print_general(
                        fp_nonchimeras, params, query_seq, query_head,
                        query_size, stats["nonchimera"],
                        score_name=score_name, score=res.best_h)

        # log-only parameter block (chimera.cpp:2562-2591)
        fp_log = getattr(params, "fp_log", None)
        if fp_log is not None:
            is_uchime = command in ("uchime_ref", "uchime_denovo",
                                    "uchime2_denovo", "uchime3_denovo")
            block = ""
            if command in ("uchime_ref", "uchime_denovo"):
                block += "%8.2f  minh\n" % params.opt_minh
            if is_uchime:
                block += "%8.2f  xn\n" % params.opt_xn
                block += "%8.2f  dn\n" % params.opt_dn
                block += "%8.2f  xa\n" % 1.0
            if command in ("uchime_ref", "uchime_denovo"):
                block += "%8.2f  mindiv\n" % params.opt_mindiv
            block += "%8.2f  id\n" % detection.opt_id
            if is_uchime:
                block += "%8d  maxp\n" % 2
            fp_log.write((block + "\n").encode())

        from ..utils.progress import Progress
        with Progress("Detecting chimeras",
                      db.nucleotidecount if not is_ref else 1,
                      params) as det_prog:
            if is_ref:
                # static reference set: rounds are pure batching
                batch = []
                def flush():
                    if not batch:
                        return
                    rqs, _ = engine.search_round(batch)
                    with timed_phase("resolve"):
                        for rq in rqs:
                            res = engine.resolve(rq, 0, None)
                            handle(res, rq.head, rq.seq, rq.size)
                            det_prog.update()
                    del batch[:]
                for rec in queries:
                    batch.append((rec.header, rec.sequence, rec.abundance,
                                  rec.seqno))
                    if len(batch) >= ROUND_SIZE:
                        flush()
                flush()
            else:
                # denovo: speculative rounds against the frozen reference
                # set + exact serial repair (core/chimera.py search_round),
                # pipelined one round deep when the growing device tier is
                # active: round i+1's part-candidate scoring dispatches
                # BEFORE round i's serial resolution, and round i's
                # accepted non-chimeras carry into round i+1's tracker
                # (ExtrasTracker.add_carry_batch) — the same exact repair,
                # one snapshot deeper
                nt_done = 0
                seqno = 0
                prev = None      # in-flight round_begin state
                carry = []       # [(seqno, kmers, length)] from prev round

                def resolve_round(rqs, tracker, carry_in):
                    nonlocal nt_done
                    tracker.add_carry_batch(carry_in)
                    new_carry = []
                    for qidx, rq in enumerate(rqs):
                        res = engine.resolve(rq, qidx, tracker)
                        handle(res, rq.head, rq.seq, rq.size)
                        if res.status < Status.suspicious:
                            kmers = rq.full_kmers.copy()
                            ln = db.getsequencelen(rq.qno)
                            index.add_sequence_with_kmers(
                                rq.qno, ln, kmers)
                            tracker.add_extra(rq.qno, kmers, ln, qidx)
                            new_carry.append((rq.qno, kmers, ln))
                        nt_done += len(rq.seq)
                        det_prog.update(nt_done)
                    return new_carry

                while seqno < db.seqcount or prev is not None:
                    width = (DEVICE_ROUND if engine._dev_index is not None
                             else ROUND_SIZE)
                    hi = min(seqno + width, db.seqcount)
                    batch = [(db.getheader(s), db.getsequence(s),
                              db.getabundance(s), s)
                             for s in range(seqno, hi)]
                    seqno = hi
                    st = engine.round_begin(batch) if batch else None
                    if prev is not None:
                        rqs, tracker = engine.round_finish(prev)
                        with timed_phase("resolve"):
                            carry = resolve_round(rqs, tracker, carry)
                        prev = None
                    if st is not None:
                        if st["pending"] is not None:
                            prev = st
                        else:
                            # resolved in-iteration: the NEXT dispatch
                            # happens after this resolution, so nothing
                            # carries forward
                            rqs, tracker = engine.round_finish(st)
                            with timed_phase("resolve"):
                                resolve_round(rqs, tracker, carry)
                            carry = []

        if not params.opt_quiet:
            _report_summary(stats, is_long)

        # log-only per-file chimera count (chimera.cpp:2731-2753)
        if fp_log is not None:
            name = (params.opt_uchime_ref if is_ref
                    else getattr(params, "opt_" + command))
            if stats["total"] > 0:
                fp_log.write(("%s: %d/%d chimeras (%.1f%%)\n" % (
                    name, stats["chimera"], stats["total"],
                    100.0 * stats["chimera"] / stats["total"])).encode())
            else:
                fp_log.write(("%s: %d/%d chimeras\n" % (
                    name, stats["chimera"], stats["total"])).encode())


def _report_summary(stats, is_long: bool) -> None:
    """reference: chimera() summary (:2609-2729)."""
    if stats["total"] > 0:
        if is_long:
            print("Found %d (%.1f%%) chimeras and %d (%.1f%%) non-chimeras "
                  "in %d unique sequences." % (
                      stats["chimera"],
                      100.0 * stats["chimera"] / stats["total"],
                      stats["nonchimera"],
                      100.0 * stats["nonchimera"] / stats["total"],
                      stats["total"]), file=sys.stderr)
        else:
            print("Found %d (%.1f%%) chimeras, %d (%.1f%%) non-chimeras,\n"
                  "and %d (%.1f%%) borderline sequences in %d unique "
                  "sequences." % (
                      stats["chimera"],
                      100.0 * stats["chimera"] / stats["total"],
                      stats["nonchimera"],
                      100.0 * stats["nonchimera"] / stats["total"],
                      stats["borderline"],
                      100.0 * stats["borderline"] / stats["total"],
                      stats["total"]), file=sys.stderr)
    else:
        if is_long:
            print("Found %d chimeras and %d non-chimeras in %d unique "
                  "sequences." % (stats["chimera"], stats["nonchimera"],
                                  stats["total"]), file=sys.stderr)
        else:
            print("Found %d chimeras, %d non-chimeras,\nand %d borderline "
                  "sequences in %d unique sequences." % (
                      stats["chimera"], stats["nonchimera"],
                      stats["borderline"], stats["total"]),
                  file=sys.stderr)

    if stats["total_ab"] > 0:
        if is_long:
            print("Taking abundance information into account, this "
                  "corresponds to\n%d (%.1f%%) chimeras and %d (%.1f%%) "
                  "non-chimeras in %d total sequences." % (
                      stats["chimera_ab"],
                      100.0 * stats["chimera_ab"] / stats["total_ab"],
                      stats["nonchimera_ab"],
                      100.0 * stats["nonchimera_ab"] / stats["total_ab"],
                      stats["total_ab"]), file=sys.stderr)
        else:
            print("Taking abundance information into account, this "
                  "corresponds to\n%d (%.1f%%) chimeras, %d (%.1f%%) "
                  "non-chimeras,\nand %d (%.1f%%) borderline sequences in "
                  "%d total sequences." % (
                      stats["chimera_ab"],
                      100.0 * stats["chimera_ab"] / stats["total_ab"],
                      stats["nonchimera_ab"],
                      100.0 * stats["nonchimera_ab"] / stats["total_ab"],
                      stats["borderline_ab"],
                      100.0 * stats["borderline_ab"] / stats["total_ab"],
                      stats["total_ab"]), file=sys.stderr)
    else:
        if is_long:
            print("Taking abundance information into account, this "
                  "corresponds to\n%d chimeras, %d non-chimeras in %d total "
                  "sequences." % (stats["chimera_ab"],
                                  stats["nonchimera_ab"],
                                  stats["total_ab"]), file=sys.stderr)
        else:
            print("Taking abundance information into account, this "
                  "corresponds to\n%d chimeras, %d non-chimeras,\nand %d "
                  "borderline sequences in %d total sequences." % (
                      stats["chimera_ab"], stats["nonchimera_ab"],
                      stats["borderline_ab"], stats["total_ab"]),
                  file=sys.stderr)
