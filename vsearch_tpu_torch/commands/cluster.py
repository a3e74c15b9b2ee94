"""cluster_fast / cluster_size / cluster_smallmem / cluster_unoise commands.

reference: src/core/cluster.cpp cluster() (:1126-1480) + the output
helpers cluster_core_results_hit/nohit (:399-585).  Counterpart of
vsearch_tpu/commands/cluster.py.
"""

from __future__ import annotations

from contextlib import ExitStack

from ..params import Masking, Parameters
from ..db import Database
from ..io import fastx as fastx_io
from ..io.attributes import header_strip
from ..core import mask as mask_mod
from ..core import results
from ..core.cluster import ClusterEngine
from ..core.otutable import OtuTable
from ..core.search import SearchContext
from ..index import KmerIndex


from ..io.openfile import open_output_opt as _open  # noqa: E402

# host-tier round width.  A pure performance knob: the same-round repair
# (evaluate_extra_hits) makes the output identical for any round size --
# the reference relies on the same property for its thread scaling
# (cluster.cpp:877-1030).  Wide rounds feed the aligner whole waves and
# amortize the candidate scoring; the native per-round repair keeps them
# cheap.  Once the device tier is active, ClusterEngine.DEVICE_ROUND
# sets the width.
ROUND_SIZE = 256


def _strip(params: Parameters, header: bytes) -> bytes:
    stripped, _ = header_strip(header, params.opt_xsize, params.opt_xee,
                               params.opt_xlength)
    return stripped


def _relabel_otu(params: Parameters, clusterno: int, sequence: bytes) -> bytes:
    """reference: cluster.cpp relabel_otu (:362-396)."""
    import hashlib
    from ..utils.digest import normalized_digest
    if params.opt_relabel is not None:
        return params.opt_relabel.encode() + b"%d" % (clusterno + 1)
    if params.opt_relabel_self:
        return sequence
    if params.opt_relabel_sha1:
        return normalized_digest(hashlib.sha1, sequence)
    if params.opt_relabel_md5:
        return normalized_digest(hashlib.md5, sequence)
    return b""


def cluster_command(params: Parameters, command: str) -> None:
    dbname = getattr(params, "opt_" + command)
    with ExitStack() as stack:
        fp_centroids = _open(stack, params.opt_centroids, "--centroids")
        fp_uc = _open(stack, params.opt_uc, "--uc")
        fp_alnout = _open(stack, params.opt_alnout, "--alnout")
        if fp_alnout is not None:
            fp_alnout.write(params.command_line.encode() + b"\n")
            fp_alnout.write(params.prog_header.encode() + b"\n")
        fp_samout = _open(stack, params.opt_samout, "--samout")
        fp_userout = _open(stack, params.opt_userout, "--userout")
        fp_blast6out = _open(stack, params.opt_blast6out, "--blast6out")
        fp_fastapairs = _open(stack, params.opt_fastapairs, "--fastapairs")
        fp_qsegout = _open(stack, params.opt_qsegout, "--qsegout")
        fp_tsegout = _open(stack, params.opt_tsegout, "--tsegout")
        fp_matched = _open(stack, params.opt_matched, "--matched")
        fp_notmatched = _open(stack, params.opt_notmatched, "--notmatched")
        fp_otutabout = _open(stack, params.opt_otutabout, "--otutabout")
        fp_mothur = _open(stack, params.opt_mothur_shared_out, "--mothur_shared_out")
        fp_biomout = _open(stack, params.opt_biomout, "--biomout")

        db = Database()
        db.read(dbname, params)
        otutab = OtuTable() if (fp_otutabout or fp_mothur or fp_biomout) else None
        if fp_samout is not None:
            results.show_samheader(fp_samout, params, dbname, db)

        # query masking (reference: cluster.cpp:1190-1198 uses qmask)
        if params.opt_qmask == Masking.dust:
            mask_mod.dust_all(db, params)
        elif params.opt_qmask == Masking.soft and params.opt_hardmask:
            mask_mod.hardmask_all(db)

        if params.opt_cluster_fast is not None:
            db.sortbylength(params)
        elif (params.opt_cluster_size is not None
              or params.opt_cluster_unoise is not None):
            db.sortbyabundance(params)

        # empty index grown during the run (cluster.cpp:1212)
        index = KmerIndex(params.opt_wordlength)
        ctx = SearchContext.build(params, db, index=index)
        engine = ClusterEngine(ctx.params, db, ctx)

        count_matched = [0]
        count_notmatched = [0]

        def on_hit(best, clusterno, si_p, si_m) -> None:
            """reference: cluster_core_results_hit (:399-511)."""
            count_matched[0] += 1
            qi = si_p.qi
            qseq_rc = si_m.qi.qsequence if (best.strand and si_m) else None
            if otutab is not None:
                if (params.opt_relabel is not None or params.opt_relabel_self
                        or params.opt_relabel_sha1 or params.opt_relabel_md5):
                    label = _relabel_otu(params, clusterno,
                                         db.getsequence(best.target))
                    otutab.add(qi.query_head, label, qi.qsize)
                else:
                    otutab.add(qi.query_head, db.getheader(best.target),
                               qi.qsize)
            if fp_uc is not None:
                results.show_uc_one(fp_uc, params, best, qi.query_head,
                                    qi.qseqlen, clusterno, db)
            if fp_alnout is not None:
                results.show_alnout(fp_alnout, params, [best], qi.query_head,
                                    qi.qsequence, qi.qseqlen, db)
            if fp_samout is not None:
                results.show_samout(fp_samout, params, [best], qi.query_head,
                                    qi.qsequence, qseq_rc, db)
            if fp_fastapairs is not None:
                results.show_fastapairs_one(fp_fastapairs, params, best,
                                            qi.query_head, qi.qsequence,
                                            qseq_rc, db)
            if fp_qsegout is not None:
                results.show_qsegout_one(fp_qsegout, params, best,
                                         qi.query_head, qi.qsequence,
                                         qi.qseqlen, qseq_rc)
            if fp_tsegout is not None:
                results.show_tsegout_one(fp_tsegout, params, best, db)
            if fp_userout is not None:
                results.show_userout_one(fp_userout, params, best,
                                         qi.query_head, qi.qsequence,
                                         qi.qseqlen, qseq_rc, db)
            if fp_blast6out is not None:
                results.show_blast6_one(fp_blast6out, params, best,
                                        qi.query_head, qi.qseqlen, db)
            if fp_matched is not None:
                fastx_io.fasta_print_general(fp_matched, params, qi.qsequence,
                                             qi.query_head, qi.qsize,
                                             count_matched[0])

        def on_nohit(clusterno, si_p) -> None:
            """reference: cluster_core_results_nohit (:514-585)."""
            count_notmatched[0] += 1
            qi = si_p.qi
            if otutab is not None:
                if (params.opt_relabel is not None or params.opt_relabel_self
                        or params.opt_relabel_sha1 or params.opt_relabel_md5):
                    label = _relabel_otu(params, clusterno, qi.qsequence)
                    otutab.add(qi.query_head, label, qi.qsize)
                else:
                    otutab.add(qi.query_head, qi.query_head, qi.qsize)
            if fp_uc is not None:
                fp_uc.write(b"S\t%d\t%d\t*\t*\t*\t*\t*\t" % (
                    engine.clusters, qi.qseqlen))
                fp_uc.write(_strip(params, qi.query_head))
                fp_uc.write(b"\t*\n")
            if params.opt_output_no_hits:
                if fp_userout is not None:
                    results.show_userout_one(fp_userout, params, None,
                                             qi.query_head, qi.qsequence,
                                             qi.qseqlen, None, db)
                if fp_blast6out is not None:
                    results.show_blast6_one(fp_blast6out, params, None,
                                            qi.query_head, qi.qseqlen, db)
            if fp_notmatched is not None:
                fastx_io.fasta_print_general(fp_notmatched, params,
                                             qi.qsequence, qi.query_head,
                                             qi.qsize, count_notmatched[0])

        from ..utils.progress import Progress, phase
        # reference narration: dbindex.prepare's counting pass runs on the
        # (empty) index before clustering (cluster.cpp:1212, dbindex.cpp:185)
        phase(params, "Counting k-mers")
        # log-only index info block (cluster.cpp:1240-1254)
        if getattr(params, "fp_log", None) is not None:
            slots = 1 << (2 * params.opt_wordlength)
            params.fp_log.write(
                ("\n      Alphabet  nt\n    Word width  %d\n"
                 "     Word ones  %d\n        Spaced  No\n"
                 "        Hashed  No\n         Coded  No\n"
                 "       Stepped  No\n         Slots  %d (%.1fk)\n"
                 "       DBAccel  100%%\n\n"
                 % (params.opt_wordlength, params.opt_wordlength, slots,
                    slots / 1000.0)).encode())
        with Progress("Clustering", db.nucleotidecount, params) as cprog:
            engine.run(ROUND_SIZE, on_hit, on_nohit, progress=cprog)

        # post-pass (cluster.cpp:1269-1480)
        seqcount = db.seqcount
        clusters = engine.clusters
        cluster_abundance = [0] * clusters
        cluster_size = [0] * clusters
        for info in engine.clusterinfo:
            ab = db.getabundance(info.seqno) if params.opt_sizein else 1
            cluster_abundance[info.clusterno] += ab
            cluster_size[info.clusterno] += 1

        with Progress("Sorting clusters", clusters, params):
            order = sorted(range(seqcount), key=(
                (lambda i: (
                    -cluster_abundance[engine.clusterinfo[i].clusterno],
                    engine.clusterinfo[i].clusterno,
                    engine.clusterinfo[i].seqno))
                if params.opt_clusterout_sort else
                (lambda i: (engine.clusterinfo[i].clusterno,
                            engine.clusterinfo[i].seqno))))

        write_progress = Progress("Writing clusters", seqcount, params)
        lastcluster = -1
        fp_clusters = None
        ordinal = 0
        for i in order:
            info = engine.clusterinfo[i]
            seqno, clusterno = info.seqno, info.clusterno
            if clusterno != lastcluster:
                if fp_centroids is not None:
                    fastx_io.fasta_print_general(
                        fp_centroids, params, db.getsequence(seqno),
                        db.getheader(seqno),
                        cluster_abundance[clusterno], clusterno + 1,
                        clusterid=(clusterno if params.opt_clusterout_id
                                   else -1),
                        centroid_size=db.getabundance(seqno))
                if fp_uc is not None:
                    fp_uc.write(b"C\t%d\t%d\t*\t*\t*\t*\t*\t" % (
                        clusterno, cluster_abundance[clusterno]))
                    fp_uc.write(_strip(params, db.getheader(seqno)))
                    fp_uc.write(b"\t*\n")
                if params.opt_clusters is not None:
                    if fp_clusters is not None:
                        fp_clusters.close()
                    ordinal = 0
                    fp_clusters = open("%s%d" % (params.opt_clusters,
                                                 clusterno), "wb")
                lastcluster = clusterno
            if fp_clusters is not None:
                ordinal += 1
                fastx_io.fasta_print_general(
                    fp_clusters, params, db.getsequence(seqno),
                    db.getheader(seqno), db.getabundance(seqno), ordinal)
        if fp_clusters is not None:
            fp_clusters.close()
        write_progress.done()

        # reference: cluster.cpp:1426-1470 — identical lines to stderr + log
        from ..utils.progress import message_both
        if clusters < 1:
            message_both(params, "Clusters: 0\nSingletons: 0\n")
        else:
            singletons = sum(1 for a in cluster_abundance if a == 1)
            message_both(
                params,
                "Clusters: %d Size min %d, max %d, avg %.1f\n"
                "Singletons: %d, %.1f%% of seqs, %.1f%% of clusters\n" % (
                    clusters, min(cluster_abundance), max(cluster_abundance),
                    1.0 * seqcount / clusters, singletons,
                    100.0 * singletons / seqcount,
                    100.0 * singletons / clusters))

        if (params.opt_msaout is not None or params.opt_consout is not None
                or params.opt_profile is not None):
            from ..core.msa import write_msa_outputs
            write_msa_outputs(params, db, engine, order, stack)

        if otutab is not None:
            if fp_biomout is not None:
                otutab.print_biomout(fp_biomout, params)
            if fp_otutabout is not None:
                otutab.print_otutabout(fp_otutabout, params)
            if fp_mothur is not None:
                otutab.print_mothur_shared_out(fp_mothur, params)
