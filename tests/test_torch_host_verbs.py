"""Every verb of the CLI end to end: the PyTorch port against the JAX
package, on seeded inputs.

The option sets are those of tests/test_commands_parity.py,
tests/test_commands_parity2.py and tests/test_differential_fuzz.py, which
hold vsearch_tpu against the reference binary; their fixture files are
replaced by seeded stand-ins made with those modules' generators.  One
more case runs the amplicon pipeline of tests/amplicon_workload.py.

The port runs every case in ONE subprocess on its CPU device, and that
process is shown to load neither jax nor vsearch_tpu; the JAX package runs
each case in process.  Every output must be byte-equal (a --log report
without its banner, command line and clock lines; a biom table without
its id and date).
"""

import json
import os
import pathlib
import random
import subprocess
import sys

import pytest

from .amplicon_workload import pipeline_steps, write_amplicon_workload
from .conftest import _common
from .test_commands_parity import _write_synthetic_sff
from .test_differential_fuzz import (_mutate, _seq, make_fasta, make_fastq,
                                     make_pairs)

REPO = pathlib.Path(__file__).resolve().parent.parent

# amplicon pairs of the pipeline case
PIPELINE_PAIRS = 1000

# runs each case's steps in its own directory; reports each case's exit
# codes (or the exception that ended it) and the modules loaded
_DRIVER = """
import json, os, sys, traceback
from vsearch_tpu_torch import cli
cases = json.load(open(sys.argv[1]))
report = {}
for name, workdir, steps in cases:
    os.chdir(workdir)
    try:
        report[name] = [cli.main(argv) for argv in steps]
    except Exception:
        report[name] = traceback.format_exc()
print(json.dumps({"cases": report, "modules": sorted(sys.modules)}))
"""


PIPELINE = pipeline_steps("{amp_f}", "{amp_r}", "{amp_tax}")


def _o(*names):
    return ["{o}." + n for n in names]


# (id, steps (each an argv with placeholders for the inputs and {o} for
# the outputs' prefix), outputs).  Both sides write the same relative
# names, each in its own directory, so that outputs which quote the
# command line (alnout, samout) are comparable
CASES = [
    # --- tests/test_commands_parity.py CASES ---
    ("derep_full", [["--derep_fulllength", "{derep}", "--output", "{o}.fa",
                     "--uc", "{o}.uc", "--sizeout", "--minseqlength", "1"]],
     _o("fa", "uc")),
    ("derep_id", [["--derep_id", "{derep}", "--output", "{o}.fa", "--sizein",
                   "--sizeout", "--minseqlength", "1"]], _o("fa")),
    ("derep_prefix", [["--derep_prefix", "{derep}", "--output", "{o}.fa",
                       "--uc", "{o}.uc", "--sizeout", "--minseqlength",
                       "1"]], _o("fa", "uc")),
    ("fastx_uniques_fastq", [["--fastx_uniques", "{pair_f}", "--fastaout",
                              "{o}.fa", "--fastqout", "{o}.fq",
                              "--tabbedout", "{o}.tsv", "--sizeout",
                              "--minseqlength", "1"]],
     _o("fa", "fq", "tsv")),
    ("sortbysize", [["--sortbysize", "{sized}", "--output", "{o}.fa",
                     "--minseqlength", "1"]], _o("fa")),
    ("sortbylength", [["--sortbylength", "{derep}", "--output", "{o}.fa",
                       "--topn", "5", "--minseqlength", "1"]], _o("fa")),
    ("shuffle", [["--shuffle", "{ref}", "--output", "{o}.fa", "--randseed",
                  "42", "--minseqlength", "1"]], _o("fa")),
    ("cluster_size", [["--cluster_size", "{derep}", "--id", "0.9", "--uc",
                       "{o}.uc", "--centroids", "{o}.fa", "--sizein",
                       "--sizeout", "--minseqlength", "1"]], _o("uc", "fa")),
    ("cluster_fast_msa", [["--cluster_fast", "{ref}", "--id", "0.6", "--uc",
                           "{o}.uc", "--centroids", "{o}.fa", "--msaout",
                           "{o}.msa", "--consout", "{o}.cons", "--profile",
                           "{o}.prof", "--minseqlength", "1"]],
     _o("uc", "fa", "msa", "cons", "prof")),
    ("uchime3_denovo", [["--uchime3_denovo", "{chim}", "--chimeras",
                         "{o}.ch.fa", "--nonchimeras", "{o}.nc.fa",
                         "--uchimeout", "{o}.tsv", "--minseqlength", "1"]],
     _o("ch.fa", "nc.fa", "tsv")),
    ("uchime_denovo", [["--uchime_denovo", "{chim}", "--chimeras",
                        "{o}.ch.fa", "--uchimeout", "{o}.tsv", "--borderline",
                        "{o}.bl.fa", "--minseqlength", "1"]],
     _o("ch.fa", "tsv", "bl.fa")),
    ("chimeras_denovo", [["--chimeras_denovo", "{long}", "--chimeras",
                          "{o}.ch.fa", "--nonchimeras", "{o}.nc.fa",
                          "--alnout", "{o}.aln", "--tabbedout", "{o}.tsv",
                          "--minseqlength", "1"]],
     _o("ch.fa", "nc.fa", "aln", "tsv")),
    ("uchime_ref", [["--uchime_ref", "{chim_q}", "--db", "{chim_db}",
                     "--chimeras", "{o}.ch.fa", "--nonchimeras", "{o}.nc.fa",
                     "--uchimeout", "{o}.tsv", "--uchimealns", "{o}.alns",
                     "--minseqlength", "1"]],
     _o("ch.fa", "nc.fa", "tsv", "alns")),
    ("mergepairs", [["--fastq_mergepairs", "{pair_f}", "--reverse",
                     "{pair_r}", "--fastqout", "{o}.fq", "--fastaout",
                     "{o}.fa", "--eetabbedout", "{o}.ee",
                     "--fastqout_notmerged_fwd", "{o}.nm.fq"]],
     _o("fq", "fa", "ee", "nm.fq")),
    ("fastq_filter", [["--fastq_filter", "{pair_f}", "--fastq_maxee", "1.0",
                       "--fastq_trunclen", "100", "--fastaout", "{o}.fa",
                       "--fastqout", "{o}.fq", "--fastqout_discarded",
                       "{o}.d.fq", "--eeout"]], _o("fa", "fq", "d.fq")),
    ("search_exact", [["--search_exact", "{derep}", "--db", "{derep}",
                       "--blast6out", "{o}.b6", "--uc", "{o}.uc",
                       "--minseqlength", "1", "--output_no_hits"]],
     _o("b6", "uc")),
    ("sintax", [["--sintax", "{chim_q}", "--db", "{tax_small}",
                 "--tabbedout", "{o}.tsv", "--randseed", "5",
                 "--sintax_cutoff", "0.8"]], _o("tsv")),
    ("allpairs", [["--allpairs_global", "{ref}", "--id", "0.5",
                   "--blast6out", "{o}.b6", "--uc", "{o}.uc",
                   "--minseqlength", "1", "--output_no_hits"]],
     _o("b6", "uc")),
    ("fastx_mask", [["--fastx_mask", "{dust}", "--fastaout", "{o}.fa"]],
     _o("fa")),
    ("maskfasta", [["--maskfasta", "{dust}", "--output", "{o}.fa",
                    "--minseqlength", "1"]], _o("fa")),
    ("fastx_revcomp", [["--fastx_revcomp", "{derep}", "--fastaout",
                        "{o}.fa"]], _o("fa")),
    ("fastx_subsample", [["--fastx_subsample", "{tax_small}", "--fastaout",
                          "{o}.fa", "--fastaout_discarded", "{o}.d.fa",
                          "--sample_size", "4", "--randseed", "7"]],
     _o("fa", "d.fa")),
    ("rereplicate", [["--rereplicate", "{sized}", "--output", "{o}.fa",
                      "--sizein"]], _o("fa")),
    ("derep_smallmem", [["--derep_smallmem", "{derep}", "--fastaout",
                         "{o}.fa", "--sizeout", "--minseqlength", "1"]],
     _o("fa")),
    ("cut", [["--cut", "{ref}", "--cut_pattern", "G^AATT_C", "--fastaout",
              "{o}.fa", "--fastaout_rev", "{o}.rev.fa",
              "--fastaout_discarded", "{o}.d.fa"]],
     _o("fa", "rev.fa", "d.fa")),
    ("fastx_getseqs", [["--fastx_getseqs", "{ref}", "--label_substr_match",
                        "--label", "chim", "--fastaout", "{o}.fa",
                        "--notmatched", "{o}.nm.fa"]], _o("fa", "nm.fa")),
    ("fastx_getsubseq", [["--fastx_getsubseq", "{derep}", "--label", "fz1",
                          "--label_substr_match", "--subseq_start", "3",
                          "--subseq_end", "10", "--fastaout", "{o}.fa"]],
     _o("fa")),
    ("fastq_eestats", [["--fastq_eestats", "{pair_f}", "--output",
                        "{o}.tsv"]], _o("tsv")),
    ("fastq_eestats2", [["--fastq_eestats2", "{pair_f}", "--output",
                         "{o}.tsv", "--length_cutoffs", "50,*,50"]],
     _o("tsv")),
    # test_udb_roundtrip_parity and test_sff_convert_parity
    ("udb_roundtrip", [["--makeudb_usearch", "{ref}", "--output", "{o}.udb"],
                       ["--udb2fasta", "{o}.udb", "--output", "{o}.fa"],
                       ["--usearch_global", "{chim_q}", "--id", "0.5",
                        "--db", "{o}.udb", "--blast6out", "{o}.b6", "--uc",
                        "{o}.uc"]],
     _o("udb", "fa", "b6", "uc")),
    ("sff_convert", [["--sff_convert", "{sff}", "--fastqout", "{o}.fq"],
                     ["--sff_convert", "{sff}", "--fastqout", "{o}.clip.fq",
                      "--sff_clip"]], _o("fq", "clip.fq")),
    # --- tests/test_commands_parity2.py CASES, LOG_CASES and udbinfo ---
    ("orient", [["--orient", "{orient_in}", "--db", "{ref}", "--fastaout",
                 "{o}.fa", "--notmatched", "{o}.nm.fa", "--tabbedout",
                 "{o}.tsv"]], _o("fa", "nm.fa", "tsv")),
    ("fastq_join", [["--fastq_join", "{pair2_f}", "--reverse", "{pair2_r}",
                     "--fastqout", "{o}.fq", "--fastaout", "{o}.fa"]],
     _o("fq", "fa")),
    ("fastq_join_pad", [["--fastq_join", "{pair2_f}", "--reverse",
                         "{pair2_r}", "--fastqout", "{o}.fq",
                         "--join_padgap", "TACG", "--join_padgapq", "KKKK"]],
     _o("fq")),
    ("fastx_syncpairs", [["--fastx_syncpairs", "{sync_f}", "--reverse",
                          "{sync_r}", "--fastqout", "{o}.f.fq",
                          "--fastqout_rev", "{o}.r.fq"]],
     _o("f.fq", "r.fq")),
    ("fasta2fastq", [["--fasta2fastq", "{derep}", "--fastqout", "{o}.fq",
                      "--fastq_qmaxout", "40"]], _o("fq")),
    ("fastq_convert", [["--fastq_convert", "{pair2_f}", "--fastqout",
                        "{o}.fq", "--fastq_asciiout", "64"]], _o("fq")),
    ("fastx_filter_paired", [["--fastx_filter", "{pair2_f}", "--reverse",
                              "{pair2_r}", "--fastq_maxee", "20",
                              "--fastq_trunclen", "100", "--fastqout",
                              "{o}.f.fq", "--fastqout_rev", "{o}.r.fq",
                              "--fastaout_discarded", "{o}.d.fa"]],
     _o("f.fq", "r.fq", "d.fa")),
    ("fastx_getseq", [["--fastx_getseq", "{ref}", "--label", "chim",
                       "--label_substr_match", "--fastaout", "{o}.fa",
                       "--notmatched", "{o}.nm.fa"]], _o("fa", "nm.fa")),
    ("cluster_smallmem", [["--cluster_smallmem", "{derep}", "--usersort",
                           "--id", "0.9", "--uc", "{o}.uc", "--centroids",
                           "{o}.fa", "--minseqlength", "1"]],
     _o("uc", "fa")),
    ("cluster_unoise", [["--cluster_unoise", "{chim}", "--sizein",
                         "--minsize", "1", "--centroids", "{o}.fa", "--uc",
                         "{o}.uc", "--sizeout", "--minseqlength", "1"]],
     _o("fa", "uc")),
    ("uchime2_denovo", [["--uchime2_denovo", "{chim}", "--sizein",
                         "--chimeras", "{o}.ch.fa", "--nonchimeras",
                         "{o}.nc.fa", "--uchimeout", "{o}.tsv",
                         "--minseqlength", "1"]],
     _o("ch.fa", "nc.fa", "tsv")),
    ("ug_fastapairs_segout", [["--usearch_global", "{chim_q}", "--db",
                               "{ref}", "--id", "0.5", "--fastapairs",
                               "{o}.pairs.fa", "--qsegout", "{o}.qseg.fa",
                               "--tsegout", "{o}.tseg.fa"]],
     _o("pairs.fa", "qseg.fa", "tseg.fa")),
    ("ug_samout", [["--usearch_global", "{chim_q}", "--db", "{ref}", "--id",
                    "0.5", "--samout", "{o}.sam", "--output_no_hits"]],
     _o("sam")),
    ("ug_matched_dbmatched", [["--usearch_global", "{chim_q}", "--db",
                               "{ref}", "--id", "0.97", "--matched",
                               "{o}.m.fa", "--notmatched", "{o}.nm.fa",
                               "--dbmatched", "{o}.dbm.fa", "--dbnotmatched",
                               "{o}.dbnm.fa", "--sizeout"]],
     _o("m.fa", "nm.fa", "dbm.fa", "dbnm.fa")),
    ("ug_otutab", [["--usearch_global", "{sample_q}", "--db", "{ref}", "--id",
                    "0.5", "--sizein", "--otutabout", "{o}.otu.tsv",
                    "--biomout", "{o}.biom", "--mothur_shared_out",
                    "{o}.mothur"]], _o("otu.tsv", "biom", "mothur")),
    ("ug_lcaout", [["--usearch_global", "{chim_q}", "--db", "{tax_ref}",
                    "--id", "0.5", "--lcaout", "{o}.lca.tsv", "--lca_cutoff",
                    "0.6", "--maxaccepts", "4", "--uc_allhits", "--uc",
                    "{o}.uc"]], _o("lca.tsv", "uc")),
    ("ug_userout_allfields", [[
        "--usearch_global", "{chim_q}", "--db", "{ref}", "--id", "0.5",
        "--userout", "{o}.user.tsv", "--output_no_hits", "--userfields",
        "query+target+evalue+id+pctpv+pctgaps+pairs+gaps+qlo+qhi+tlo+thi+pv"
        "+ql+tl+qs+ts+alnlen+opens+exts+raw+bits+aln+caln+qstrand+tstrand"
        "+qrow+trow+qframe+tframe+mism+ids+qcov+tcov+id0+id1+id2+id3+id4"
        "+qilo+qihi+tilo+tihi"]], _o("user.tsv")),
    ("ug_maxhits_tophits", [["--usearch_global", "{chim_q}", "--db", "{ref}",
                             "--id", "0.4", "--maxaccepts", "8", "--maxhits",
                             "2", "--blast6out", "{o}.b6", "--strand",
                             "both"]], _o("b6")),
    ("log_fastq_chars", [["--fastq_chars", "{pair2_f}", "--log",
                          "{o}.log"]], _o("log")),
    ("log_fastq_stats", [["--fastq_stats", "{pair2_f}", "--log", "{o}.log"]],
     _o("log")),
    ("udbinfo_udbstats", [["--makeudb_usearch", "{ref}", "--output",
                           "{o}.udb"],
                          ["--udbinfo", "{o}.udb", "--log", "{o}.info.log"],
                          ["--udbstats", "{o}.udb", "--log",
                           "{o}.stats.log"]],
     _o("info.log", "stats.log")),
    # --- tests/test_differential_fuzz.py ---
    ("fuzz_derep_sizein", [["--derep_fulllength", "{fz_derep}", "--output",
                            "{o}.fa", "--minseqlength", "1", "--sizein",
                            "--sizeout", "--uc", "{o}.uc"]], _o("fa", "uc")),
    ("fuzz_derep_id", [["--derep_id", "{fz_derep}", "--output", "{o}.fa",
                        "--minseqlength", "1", "--sizeout"]], _o("fa")),
    ("fuzz_derep_prefix", [["--derep_prefix", "{fz_derep}", "--output",
                            "{o}.fa", "--minseqlength", "1", "--sizein",
                            "--sizeout"]], _o("fa")),
    ("fuzz_derep_both_topn", [["--derep_fulllength", "{fz_derep}",
                               "--output", "{o}.fa", "--minseqlength", "1",
                               "--strand", "both", "--sizeout", "--topn",
                               "20"]], _o("fa")),
] + [
    ("fuzz_" + verb, [["--" + verb, "{fz_clu}", "--id", "0.92", "--uc",
                       "{o}.uc", "--centroids", "{o}.fa", "--sizein",
                       "--sizeout", "--minseqlength", "1"]
                      + (["--usersort"] if verb == "cluster_smallmem"
                         else [])],
     _o("uc", "fa"))
    for verb in ("cluster_size", "cluster_fast", "cluster_smallmem")
] + [
    ("fuzz_fastq_filter", [["--fastq_filter", "{fz_fq}", "--fastq_maxee",
                            "0.8", "--fastq_truncqual", "15",
                            "--fastq_minlen", "30", "--fastaout", "{o}.fa",
                            "--fastqout", "{o}.fq", "--fastqout_discarded",
                            "{o}.d.fq", "--eeout"]], _o("fa", "fq", "d.fq")),
    ("fuzz_fastx_filter_strip", [["--fastx_filter", "{fz_fq}",
                                  "--fastq_stripleft", "5",
                                  "--fastq_stripright", "3",
                                  "--fastq_trunclen_keep", "120",
                                  "--fastq_maxns", "2", "--fastqout",
                                  "{o}.fq"]], _o("fq")),
    ("fuzz_fastq_stats", [["--fastq_stats", "{fz_fq}", "--log", "{o}.log"]],
     _o("log")),
    ("fuzz_fastq_chars", [["--fastq_chars", "{fz_fq}", "--log", "{o}.log"]],
     _o("log")),
    ("fuzz_fastx_revcomp", [["--fastx_revcomp", "{fz_fq}", "--fastqout",
                             "{o}.fq", "--label_suffix", "_rc"]], _o("fq")),
    ("fuzz_fastq_convert", [["--fastq_convert", "{fz_fq}", "--fastqout",
                             "{o}.fq", "--fastq_asciiout", "64"]], _o("fq")),
    ("fuzz_mergepairs_stagger", [["--fastq_mergepairs", "{fz_f}",
                                  "--reverse", "{fz_r}", "--fastqout",
                                  "{o}.fq", "--fastaout_notmerged_fwd",
                                  "{o}.nf.fa", "--fastaout_notmerged_rev",
                                  "{o}.nr.fa", "--eetabbedout", "{o}.ee",
                                  "--fastq_allowmergestagger"]],
     _o("fq", "nf.fa", "nr.fa", "ee")),
    ("fuzz_mergepairs_limits", [["--fastq_mergepairs", "{fz_f}",
                                 "--reverse", "{fz_r}", "--fastaout",
                                 "{o}.fa", "--fastq_minovlen", "20",
                                 "--fastq_maxdiffs", "4",
                                 "--fastq_minmergelen", "100"]], _o("fa")),
] + [
    ("fuzz_" + verb, [["--" + verb, "{chim}", "--chimeras", "{o}.ch.fa",
                       "--nonchimeras", "{o}.nc.fa", "--uchimeout",
                       "{o}.tsv", "--minseqlength", "1"]],
     _o("ch.fa", "nc.fa", "tsv"))
    for verb in ("uchime_denovo", "uchime2_denovo", "uchime3_denovo")
] + [
    ("fuzz_subsample_pct", [["--fastx_subsample", "{fz_misc}", "--fastaout",
                             "{o}.fa", "--sample_pct", "35.5", "--randseed",
                             "9", "--sizein", "--sizeout",
                             "--fastaout_discarded", "{o}.d.fa"]],
     _o("fa", "d.fa")),
    ("fuzz_sortbysize_minsize", [["--sortbysize", "{fz_misc}", "--output",
                                  "{o}.fa", "--sizein", "--minsize", "3",
                                  "--minseqlength", "1"]], _o("fa")),
    ("fuzz_sortbylength", [["--sortbylength", "{fz_misc}", "--output",
                            "{o}.fa", "--minseqlength", "1"]], _o("fa")),
    ("fuzz_shuffle", [["--shuffle", "{fz_misc}", "--output", "{o}.fa",
                       "--randseed", "3", "--minseqlength", "1"]], _o("fa")),
    ("fuzz_rereplicate", [["--rereplicate", "{fz_misc}", "--output",
                           "{o}.fa", "--sizein"]], _o("fa")),
    ("fuzz_fastx_mask_hard", [["--fastx_mask", "{fz_misc}", "--fastaout",
                               "{o}.fa", "--qmask", "dust", "--hardmask"]],
     _o("fa")),
    ("fuzz_search_exact_both", [["--search_exact", "{fz_misc}", "--db",
                                 "{fz_misc}", "--uc", "{o}.uc",
                                 "--blast6out", "{o}.b6", "--minseqlength",
                                 "1", "--strand", "both"]], _o("uc", "b6")),
    ("fuzz_relabel", [["--fastx_filter", "{fz_rel}", "--fastaout", "{o}.fa",
                       "--relabel", "read_", "--sizein", "--sizeout",
                       "--fastq_minlen", "25"]], _o("fa")),
    ("fuzz_relabel_sha1", [["--fastx_filter", "{fz_rel}", "--fastaout",
                            "{o}.fa", "--relabel_sha1", "--sizein",
                            "--xsize"]], _o("fa")),
    ("fuzz_relabel_md5", [["--fastx_filter", "{fz_rel}", "--fastaout",
                           "{o}.fa", "--relabel_md5", "--lengthout"]],
     _o("fa")),
    ("fuzz_derep_relabel_keep", [["--derep_fulllength", "{fz_rel}",
                                  "--output", "{o}.fa", "--relabel_keep",
                                  "--relabel", "Uniq", "--sizein",
                                  "--sizeout", "--minseqlength", "1"]],
     _o("fa")),
    ("fuzz_sortbysize_relabel_self", [["--sortbysize", "{fz_rel}",
                                       "--output", "{o}.fa", "--sizein",
                                       "--relabel_self", "--sizeout",
                                       "--minseqlength", "1"]], _o("fa")),
    ("fuzz_filter_sample", [["--fastx_filter", "{fz_rel}", "--fastaout",
                             "{o}.fa", "--sample", "mysample", "--sizein"]],
     _o("fa")),
    ("fuzz_orient", [["--orient", "{fz_or_in}", "--db", "{fz_or_db}",
                      "--fastaout", "{o}.fa", "--notmatched", "{o}.nm.fa",
                      "--tabbedout", "{o}.tsv"]], _o("fa", "nm.fa", "tsv")),
    ("fuzz_fastq_join_pad", [["--fastq_join", "{fz_j_f}", "--reverse",
                              "{fz_j_r}", "--fastqout", "{o}.fq",
                              "--join_padgap", "NNNNN", "--join_padgapq",
                              "IIIII"]], _o("fq")),
    ("fuzz_fastx_getseq", [["--fastx_getseq", "{fz_or_db}", "--label",
                            "ref1", "--fastaout", "{o}.fa", "--notmatched",
                            "{o}.nm.fa"]], _o("fa", "nm.fa")),
    ("fuzz_fastx_getseqs_labels", [["--fastx_getseqs", "{fz_or_db}",
                                    "--labels", "{labels}", "--fastaout",
                                    "{o}.fa"]], _o("fa")),
    ("fuzz_sintax", [["--sintax", "{fz_sx_q}", "--db", "{fz_sx_db}",
                      "--tabbedout", "{o}.tsv", "--randseed", "11",
                      "--sintax_cutoff", "0.6"]], _o("tsv")),
    ("fuzz_allpairs_acceptall", [["--allpairs_global", "{fz_sx_q}", "--id",
                                  "0.6", "--uc", "{o}.uc", "--blast6out",
                                  "{o}.b6", "--acceptall", "--minseqlength",
                                  "1"]], _o("uc", "b6")),
    # --- the amplicon pipeline of chip_smoke.py's phase 3, small ---
    ("amplicon_pipeline", [argv for _, argv, _ in PIPELINE],
     [o for _, _, outs in PIPELINE for o in outs]),
]

NAMES = [c[0] for c in CASES]
assert len(set(NAMES)) == len(NAMES)


def _write_fasta(path, recs):
    with open(path, "w") as fh:
        for head, seq in recs:
            fh.write(">%s\n%s\n" % (head, seq))
    return path


def _inputs(d):
    """The seeded inputs, each under the placeholder name CASES use."""
    comp = str.maketrans("ACGT", "TGCA")
    data = {}
    # stand-ins for the reference's api_examples fixtures
    data["derep"] = d / "derep.fa"
    make_fasta(data["derep"], random.Random(1), 60, minlen=10, maxlen=200,
               amb=0.02, lower=0.1, sizes=True, dupes=0.4)
    data["pair_f"], data["pair_r"] = d / "pair_f.fq", d / "pair_r.fq"
    make_pairs(data["pair_f"], data["pair_r"], random.Random(2), 60)
    data["sized"] = d / "sized.fa"
    make_fasta(data["sized"], random.Random(3), 40, minlen=30, maxlen=150,
               sizes=True, dupes=0.0)
    rng = random.Random(4)
    parents = [_seq(rng, rng.randint(250, 400)) for _ in range(10)]
    ref = [("chimera_ref%d" % i if i % 3 else "ref%d" % i, s)
           for i, s in enumerate(parents + [_mutate(rng, p, 0.05)
                                            for p in parents])]
    data["ref"] = _write_fasta(d / "ref.fa", ref)
    queries = []
    for i in range(16):
        a, b = rng.sample(parents, 2)
        cut = rng.randint(80, 200)
        s = a[:cut] + b[cut:] if i % 2 else _mutate(rng, a, 0.03)
        queries.append(("q%d" % i, s))
    data["chim_q"] = _write_fasta(d / "chim_q.fa", queries)
    data["chim_db"] = _write_fasta(d / "chim_db.fa", [
        ("p%d" % i, s) for i, s in enumerate(parents)])
    data["tax_small"] = _write_fasta(d / "tax_small.fa", [
        ("t%d;tax=d:Bacteria,p:P%d,g:G%d,s:S%d" % (i, i % 2, i % 4, i), s)
        for i, s in enumerate(parents)])
    data["tax_ref"] = _write_fasta(d / "tax_ref.fa", [
        ("%s;tax=d:Bacteria,p:Phy%d,c:Cls,o:Ord,f:Fam,g:Gen%d,s:Spec%d"
         % (h, i % 2, i % 3, i), s) for i, (h, s) in enumerate(ref)])
    data["sample_q"] = _write_fasta(d / "sample_q.fa", [
        ("%s;sample=s%d;size=%d" % (h, i % 3, 1 + i), s)
        for i, (h, s) in enumerate(queries)])
    data["orient_in"] = _write_fasta(d / "orient_in.fa", [
        (h + "_rc", s.translate(comp)[::-1]) if i % 2 else (h, s)
        for i, (h, s) in enumerate(queries)])
    # low-complexity stretches for DUST
    dust = []
    for i in range(20):
        rep = rng.choice(["A", "AT", "CAG", "GGT", "ACGTT"])
        s = (_seq(rng, rng.randint(20, 80)) + rep * rng.randint(8, 30)
             + _seq(rng, rng.randint(20, 80)))
        dust.append(("dust%d" % i, s))
    data["dust"] = _write_fasta(d / "dust.fa", dust)
    # the paired set of test_commands_parity2's fixdir, and its desynced
    # copies
    rng = random.Random(20260818)
    data["pair2_f"], data["pair2_r"] = d / "pair2_f.fq", d / "pair2_r.fq"
    with open(data["pair2_f"], "w") as ff, open(data["pair2_r"], "w") as fr:
        for i in range(24):
            frag = _seq(rng, 180)
            fwd, rev = frag[:120], frag[60:].translate(comp)[::-1]
            qf = "".join(chr(33 + rng.randint(2, 40)) for _ in fwd)
            qr = "".join(chr(33 + rng.randint(2, 40)) for _ in rev)
            ff.write("@pair%d/1\n%s\n+\n%s\n" % (i, fwd, qf))
            fr.write("@pair%d/2\n%s\n+\n%s\n" % (i, rev, qr))
    fwd_recs = data["pair2_f"].read_text().split("\n")
    rev_recs = data["pair2_r"].read_text().split("\n")
    data["sync_f"], data["sync_r"] = d / "sync_f.fq", d / "sync_r.fq"
    data["sync_f"].write_text("".join(
        "\n".join(fwd_recs[4 * i:4 * i + 4]) + "\n"
        for i in range(24) if i % 5 != 1))
    data["sync_r"].write_text("".join(
        "\n".join(rev_recs[4 * i:4 * i + 4]) + "\n"
        for i in range(24) if i % 7 != 2))
    data["sff"] = d / "test.sff"
    _write_synthetic_sff(data["sff"])
    # the corpora of tests/test_differential_fuzz.py, from its seeds
    data["fz_derep"] = d / "fz_derep.fa"
    make_fasta(data["fz_derep"], random.Random(11), 120, minlen=5,
               maxlen=250, amb=0.05, lower=0.15, sizes=True, dupes=0.35)
    rng = random.Random(31)
    base = [_seq(rng, rng.randint(200, 400)) for _ in range(12)]
    data["fz_clu"] = d / "fz_clu.fa"
    with open(data["fz_clu"], "w") as fh:
        i = 0
        for b in base:
            for _ in range(rng.randint(1, 8)):
                fh.write(">c%d;size=%d\n%s\n"
                         % (i, rng.randint(1, 99), _mutate(rng, b, 0.04)))
                i += 1
    data["fz_fq"] = d / "fz.fq"
    make_fastq(data["fz_fq"], random.Random(41), 150, minlen=20, maxlen=280)
    data["fz_f"], data["fz_r"] = d / "fz_f.fq", d / "fz_r.fq"
    make_pairs(data["fz_f"], data["fz_r"], random.Random(51), 200)
    rng = random.Random(61)
    parents = [_seq(rng, 350) for _ in range(8)]
    data["chim"] = d / "chim.fa"
    with open(data["chim"], "w") as fh:
        i = 0
        for p in parents:
            fh.write(">p%d;size=%d\n%s\n" % (i, rng.randint(50, 200), p))
            i += 1
        for _ in range(10):
            a, b = rng.sample(parents, 2)
            cut = rng.randint(100, 250)
            fh.write(">x%d;size=%d\n%s\n" % (i, rng.randint(1, 4),
                                             a[:cut] + b[cut:]))
            i += 1
    # chimeras_denovo: the fuzz chimera set and the long-read fixture
    data["long"] = d / "long.fa"
    data["long"].write_bytes(data["chim"].read_bytes() + (
        REPO / "tests" / "data" / "chimeras_long.fasta").read_bytes())
    data["fz_misc"] = d / "fz_misc.fa"
    make_fasta(data["fz_misc"], random.Random(71), 80, minlen=30,
               maxlen=200, amb=0.04, lower=0.2, sizes=True)
    data["fz_rel"] = d / "fz_rel.fa"
    make_fasta(data["fz_rel"], random.Random(81), 60, minlen=20, maxlen=120,
               amb=0.03, lower=0.1, sizes=True)
    rng = random.Random(91)
    db = [_seq(rng, rng.randint(200, 350)) for _ in range(20)]
    data["fz_or_db"] = _write_fasta(d / "fz_or_db.fa", [
        ("ref%d some description" % i, s) for i, s in enumerate(db)])
    recs = []
    for i in range(40):
        s = _mutate(rng, rng.choice(db), 0.05)
        if rng.random() < 0.5:
            s = s.translate(comp)[::-1]
        recs.append(("q%d" % i, s))
    data["fz_or_in"] = _write_fasta(d / "fz_or_in.fa", recs)
    data["fz_j_f"], data["fz_j_r"] = d / "fz_j_f.fq", d / "fz_j_r.fq"
    make_pairs(data["fz_j_f"], data["fz_j_r"], rng, 60)
    data["labels"] = d / "labels.txt"
    data["labels"].write_text("ref2\nref15\nref7\n")
    rng = random.Random(101)
    genera = [_seq(rng, 300) for _ in range(6)]
    data["fz_sx_db"] = d / "fz_sx_db.fa"
    with open(data["fz_sx_db"], "w") as fh:
        for g, b in enumerate(genera):
            for i in range(3):
                fh.write(">r%d_%d;tax=d:Bacteria,p:P%d,g:G%d;\n%s\n"
                         % (g, i, g % 3, g, _mutate(rng, b, 0.02)))
    data["fz_sx_q"] = _write_fasta(d / "fz_sx_q.fa", [
        ("q%d" % i, _mutate(rng, rng.choice(genera), 0.06))
        for i in range(25)])
    amp = d / "amp"
    amp.mkdir()
    data["amp_f"], data["amp_r"], data["amp_tax"] = \
        write_amplicon_workload(amp, pairs=PIPELINE_PAIRS)
    return {k: str(v) for k, v in data.items()}


def _steps(case, data):
    return [_common([a.format(o="out", **data) for a in argv])
            for argv in case[1]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs, and the port's run of every case (one subprocess)."""
    root = tmp_path_factory.mktemp("host_verbs")
    (root / "in").mkdir()
    data = _inputs(root / "in")
    cases = []
    for case in CASES:
        wd = root / "port" / case[0]
        wd.mkdir(parents=True)
        cases.append((case[0], str(wd), _steps(case, data)))
    spec = root / "cases.json"
    spec.write_text(json.dumps(cases))
    env = dict(os.environ)
    env["VSEARCH_TPU_TORCH_DEVICE"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.run([sys.executable, "-c", _DRIVER, str(spec)],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return root, data, json.loads(proc.stdout.strip().splitlines()[-1])


def _filter_log(raw: bytes) -> bytes:
    """A --log report without its banner, command line and clock lines."""
    return b"\n".join(
        line for line in raw.splitlines()[2:]
        if not line.startswith((b"Started ", b"Finished ", b"Elapsed time",
                                b"Max memory")))


def _norm_biom(raw: bytes) -> bytes:
    return b"\n".join(line for line in raw.splitlines()
                      if not line.lstrip().startswith((b'"id":',
                                                       b'"date":')))


def test_port_process_loads_neither_jax_nor_vsearch_tpu(runs):
    loaded = runs[2]["modules"]
    assert "vsearch_tpu_torch.commands.derep" in loaded
    assert not [m for m in loaded if m == "jax" or m.startswith("jax.")]
    assert not [m for m in loaded
                if m == "vsearch_tpu" or m.startswith("vsearch_tpu.")]


@pytest.mark.parametrize("case", CASES, ids=NAMES)
def test_verb_matches_jax(runs, case):
    from vsearch_tpu import cli
    root, data, report = runs
    rcs = report["cases"][case[0]]
    assert rcs == [0] * len(case[1]), rcs
    wd = root / "jax" / case[0]
    wd.mkdir(parents=True)
    old = os.getcwd()
    os.chdir(wd)
    try:
        for argv in _steps(case, data):
            assert cli.main(argv) == 0, argv
    finally:
        os.chdir(old)
    nonempty = 0
    for out in case[2]:
        mine = (wd / out.format(o="out")).read_bytes()
        port = (root / "port" / case[0] / out.format(o="out")).read_bytes()
        if out.endswith(".log"):
            mine, port = _filter_log(mine), _filter_log(port)
        elif out.endswith(".biom"):
            mine, port = _norm_biom(mine), _norm_biom(port)
        assert mine == port, "output %s differs for %s" % (out, case[0])
        nonempty += bool(mine)
    assert nonempty, "every output of %s is empty" % case[0]
