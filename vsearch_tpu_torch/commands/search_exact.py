"""search_exact command: hash-equality search with the usearch_global
output surface.

Counterpart of vsearch_tpu/commands/search_exact.py: its search context
speaks the port's batched driver interface.

reference: src/commands/search_exact.cpp + src/core/dbhash.{cpp,hpp} —
whole-sequence hash of the normalized sequence; every identical DB sequence
becomes a 100%-identity hit, filtered through the same accept cascade.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..params import Parameters
from ..db import Database
from ..utils.digest import normalize
from ..utils.maps import reverse_complement
from ..core.searchcore import (Hit, QueryInfo, join_hits,
                               search_acceptable_aligned,
                               search_acceptable_unaligned)


class DbHash:
    """reference: core/dbhash.cpp — normalized-sequence exact index.

    Matching seqnos are returned in insertion (seqno) order, like the
    reference's linear-probe chain."""

    def __init__(self, db: Database) -> None:
        self.table: Dict[bytes, List[int]] = {}
        for seqno in range(db.seqcount):
            key = normalize(db.getsequence(seqno))
            self.table.setdefault(key, []).append(seqno)

    def search(self, seq: bytes) -> List[int]:
        return self.table.get(normalize(seq), [])


def _exact_hit(params: Parameters, qi: QueryInfo, db, seqno: int) -> Hit:
    """reference: search_exact.cpp add_hit (:137-189)."""
    hit = Hit(target=seqno, strand=qi.strand, count=0)
    hit.nwscore = qi.qseqlen * params.opt_match
    hit.nwdiff = 0
    hit.nwgaps = 0
    hit.nwindels = 0
    hit.nwalignmentlength = qi.qseqlen
    hit.nwid = 100.0
    hit.matches = qi.qseqlen
    hit.mismatches = 0
    hit.nwalignment = "%dM" % qi.qseqlen
    hit.internal_alignmentlength = qi.qseqlen
    hit.internal_gaps = 0
    hit.internal_indels = 0
    hit.id = hit.id0 = hit.id1 = hit.id2 = hit.id3 = hit.id4 = 100.0
    hit.shortest = qi.qseqlen
    hit.longest = qi.qseqlen
    hit.aligned = True
    return hit


class ExactSearchContext:
    """SearchContext's batched interface over the exact hash: the shared
    command driver (usearch_global.run_search_output) calls
    prepare_tasks, search_tasks_begin/search_tasks_finish and join_task.
    No device index, so the driver keeps its host batch."""

    device_index = None

    def __init__(self, params: Parameters, db: Database) -> None:
        import dataclasses
        effective = dataclasses.replace(params)
        seqcount = db.seqcount
        if effective.opt_maxrejects == 0 or effective.opt_maxrejects > seqcount:
            effective.opt_maxrejects = seqcount
        if effective.opt_maxaccepts == 0 or effective.opt_maxaccepts > seqcount:
            effective.opt_maxaccepts = seqcount
        # search_exact forces 100% identity (search_exact.cpp:594-601)
        effective.opt_id = 1.0
        self.params = effective
        self.db = db
        self.dbhash = DbHash(db)

    def prepare_tasks(self, recs):
        """One QueryTask per record, its strands unmasked (the hash
        normalizes case)."""
        from ..core.search import QueryTask
        strands = 2 if self.params.opt_strand else 1
        tasks = []
        for rec in recs:
            seqs = [rec.sequence]
            if strands > 1:
                seqs.append(reverse_complement(rec.sequence))
            tasks.append(QueryTask(rec.header, rec.abundance, rec.seqno,
                                   seqs, [None] * strands))
        return tasks

    def search_tasks_begin(self, tasks):
        return tasks

    def search_tasks_finish(self, tasks) -> None:
        params = self.params
        for task in tasks:
            for strand, seq in enumerate(task.seqs):
                qi = QueryInfo(query_head=task.query_head, qsequence=seq,
                               qseqlen=len(seq), qsize=task.qsize,
                               strand=strand, query_no=task.query_no)
                hits: List[Hit] = []
                for seqno in self.dbhash.search(seq):
                    if search_acceptable_unaligned(params, qi, self.db,
                                                   seqno):
                        hit = _exact_hit(params, qi, self.db, seqno)
                        search_acceptable_aligned(params, qi, self.db, hit)
                        hits.append(hit)
                task.hits[strand] = hits

    def join_task(self, task) -> List[Hit]:
        return join_hits(self.params, task.hits[0],
                         task.hits[1] if len(task.hits) > 1 else None)


def search_exact(params: Parameters) -> None:
    from .usearch_global import run_search_output
    from ..core import mask as mask_mod
    from ..params import Masking
    from ..utils.progress import phase
    db = Database()
    # search_exact loads the db with upcase (search_exact.cpp prep)
    db.read(params.opt_db, params)
    # db masking before hashing (reference: search_exact.cpp:645-651);
    # hardmask changes the hashed bytes, dust-soft does not (normalize
    # upcases) but the narration still shows the phase
    if params.opt_dbmask == Masking.dust:
        mask_mod.dust_all(db, params)
    elif params.opt_dbmask == Masking.soft and params.opt_hardmask:
        mask_mod.hardmask_all(db)
    phase(params, "Hashing database sequences")
    ctx = ExactSearchContext(params, db)
    run_search_output(params, db, ctx, params.opt_search_exact)
