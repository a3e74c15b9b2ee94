"""Command-line interface mirroring the reference's option surface.

reference: src/cli.cc (254 long options, enum-indexed table, per-command
permitted-option handling) and src/vsearch.cc dispatch_command.  Options are
declared in a table (name -> Parameters field + type) and parsed getopt_long
style: every option takes a required argument except the flag set below.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

from .params import INT64_MAX, Masking, Parameters
from .cli_matrix import OPTION_ARITY, OPTION_ORDER, VALID_OPTIONS

PROG_NAME = "vsearch"
PROG_VERSION = "v2.31.0_tpu"

# commands (option name == Parameters field suffix)
COMMANDS = [
    "allpairs_global", "chimeras_denovo", "cluster_fast", "cluster_size",
    "cluster_smallmem", "cluster_unoise", "cut", "derep_fulllength",
    "derep_id", "derep_prefix", "derep_smallmem", "fasta2fastq",
    "fastq_chars", "fastq_convert", "fastq_eestats", "fastq_eestats2",
    "fastq_filter", "fastq_join", "fastq_mergepairs", "fastq_stats",
    "fastx_filter", "fastx_getseq", "fastx_getseqs", "fastx_getsubseq",
    "fastx_mask", "fastx_revcomp", "fastx_subsample", "fastx_syncpairs",
    "fastx_uniques", "makeudb_usearch", "maskfasta", "orient", "rereplicate",
    "search_exact", "sff_convert", "shuffle", "sintax", "sortbylength",
    "sortbysize", "uchime2_denovo", "uchime3_denovo", "uchime_denovo",
    "uchime_ref", "udb2fasta", "udbinfo", "udbstats", "usearch_global",
]

# options whose Parameters field takes the raw string
STR_OPTS = [
    "alnout", "biomout", "blast6out", "borderline", "centroids", "chimeras",
    "clusters", "consout", "db", "dbmatched", "dbnotmatched", "eetabbedout",
    "fastaout", "fastaout_discarded", "fastaout_discarded_rev",
    "fastaout_notmerged_fwd", "fastaout_notmerged_rev", "fastaout_rev",
    "fastapairs", "fastqout", "fastqout_discarded", "fastqout_discarded_rev",
    "fastqout_notmerged_fwd", "fastqout_notmerged_rev", "fastqout_rev",
    "label", "label_field", "label_suffix", "label_word", "label_words",
    "labels", "lcaout", "log", "matched", "mothur_shared_out", "msaout",
    "nonchimeras", "notmatched", "notmatchedfq", "otutabout", "output",
    "profile", "qsegout", "relabel", "reverse", "sample", "samout",
    "tabbedout", "tsegout", "uc", "uchimealns", "uchimeout", "userout",
    "cut_pattern", "join_padgap", "join_padgapq", "read_separators",
    "fastaout_orphans", "fastaout_orphans_rev", "fastqout_orphans",
    "fastqout_orphans_rev", "pattern",
]

INT_OPTS = [
    "alignwidth", "chimeras_length_min", "chimeras_parents_max",
    "chimeras_parts", "fasta_width", "fastq_ascii",
    "fastq_asciiout", "fastq_maxdiffs", "fastq_maxlen", "fastq_maxmergelen",
    "fastq_maxns", "fastq_minlen", "fastq_minmergelen", "fastq_minovlen",
    "fastq_minqual", "fastq_qmax", "fastq_qmaxout", "fastq_qmin",
    "fastq_qminout", "fastq_stripleft", "fastq_stripright", "fastq_tail",
    "fastq_trunclen", "fastq_trunclen_keep", "fastq_truncqual",
    "iddef", "idprefix", "idsuffix", "length_cutoffs_increment",
    "length_cutoffs_longest", "length_cutoffs_shortest", "match",
    "maxaccepts", "maxdiffs", "maxgaps", "maxhits", "maxqsize",
    "maxrejects", "maxseqlength", "maxsize", "maxsubs", "maxuniquesize",
    "mincols", "mindiffs", "minseqlength", "minsize", "mintsize",
    "minuniquesize", "minwordmatches", "mismatch", "randseed", "rowlen",
    "sample_size", "slots", "subseq_end", "subseq_start", "threads", "topn",
    "wordlength",
]

FLOAT_OPTS = [
    "abskew", "chimeras_diff_pct", "dn", "fastq_maxdiffpct", "fastq_maxee",
    "fastq_maxee_rate", "fastq_truncee", "fastq_truncee_rate", "id",
    "lca_cutoff", "max_unmasked_pct", "maxid", "maxqt", "maxsizeratio",
    "maxsl", "mid", "min_unmasked_pct", "mindiv", "minh", "minqt",
    "minsizeratio", "minsl", "query_cov", "sample_pct", "sintax_cutoff",
    "target_cov", "unoise_alpha", "weak_id", "xn",
]

FLAG_OPTS = [
    "bzip2_decompress", "centroid_sizeout", "clusterout_id",
    "clusterout_sort", "eeout", "fasta_score", "fastq_allowmergestagger",
    "fastq_eeout", "fastq_nostagger", "fastq_qout_max", "gzip_decompress",
    "hardmask", "label_substr_match", "lengthout", "n_mismatch",
    "no_progress", "notrunclabels", "quiet", "relabel_keep", "relabel_md5",
    "relabel_self", "relabel_sha1", "samheader", "sff_clip", "sintax_random",
    "sizein", "sizeorder", "sizeout", "uc_allhits", "xee", "xlength",
    "xsize", "acceptall", "leftjust", "rightjust", "output_no_hits",
    "self", "selfid", "top_hits_only", "usersort",
]
# reference: these int64 "flag" options are plain no-argument toggles in the
# CLI (cli.cc option table second column = false)
_INT_FLAGS = {"acceptall", "leftjust", "rightjust", "output_no_hits", "self",
              "selfid", "top_hits_only", "usersort"}


class CliError(Exception):
    pass


# commands the reference runs multithreaded (cli.cc configure_threads,
# :4112-4148); every other command forces --threads 1 with a warning
_MT_COMMANDS = frozenset((
    "allpairs_global", "cluster_fast", "cluster_size", "cluster_smallmem",
    "cluster_unoise", "fastq_mergepairs", "fastx_mask", "maskfasta",
    "search_exact", "sintax", "uchime_ref", "usearch_global"))


def parse_gap_penalty_string(arg: str, is_open: bool,
                             params: Parameters) -> None:
    """reference: cli.cc args_get_gap_penalty_string (:179-330)."""
    max_gap_penalty = 32767 // 5
    cursor = 0
    prefix = "gap_open" if is_open else "gap_extension"
    while cursor < len(arg):
        is_infinite = False
        num = ""
        while cursor < len(arg) and (arg[cursor].isdigit()
                                     or (arg[cursor] == "-" and not num)):
            num += arg[cursor]
            cursor += 1
        if num:
            pen = int(num)
            if pen < 0 or pen > max_gap_penalty:
                raise CliError(
                    "A finite gap penalty must be in the range 0 to %d; "
                    "use '*' to declare an infinite penalty" % max_gap_penalty)
        elif cursor < len(arg) and arg[cursor] == "*":
            pen = 2**31 - 1
            is_infinite = True
            cursor += 1
        else:
            raise CliError("Invalid gap penalty argument (%s)" % arg[cursor:])

        set_E = set_I = set_L = set_R = set_Q = set_T = False
        while cursor < len(arg) and arg[cursor] != "/":
            c = arg[cursor]
            if c == "E":
                set_E = True
            elif c == "I":
                set_I = True
            elif c == "L":
                set_L = True
            elif c == "R":
                set_R = True
            elif c == "Q":
                set_Q = True
            elif c == "T":
                set_T = True
            else:
                raise CliError("Invalid char '%s' in gap penalty string" % c)
            cursor += 1
        if cursor < len(arg) and arg[cursor] == "/":
            cursor += 1
        if set_E and (set_L or set_R):
            raise CliError("Invalid gap penalty string (E and L or R)")
        if set_E:
            set_L = set_R = True
        if not (set_L or set_I or set_R):
            set_L = set_I = set_R = True
        if not (set_Q or set_T):
            set_Q = set_T = True
        for qt, enabled_qt in (("query", set_Q), ("target", set_T)):
            if not enabled_qt:
                continue
            for pos, enabled in (("left", set_L), ("interior", set_I),
                                 ("right", set_R)):
                if not enabled:
                    continue
                setattr(params, "opt_%s_%s_%s" % (prefix, qt, pos), pen)
                setattr(params, "opt_%s_%s_%s_infinite" % (prefix, qt, pos),
                        is_infinite)


# the tool this framework reimplements; shown by --version/--help
# (reference: vsearch.cc show_publication)
_PUBLICATION = (
    "Rognes T, Flouri T, Nichols B, Quince C, Mahe F (2016)\n"
    "VSEARCH: a versatile open source tool for metagenomics\n"
    "PeerJ 4:e2584 doi: 10.7717/peerj.2584 "
    "https://doi.org/10.7717/peerj.2584\n\n")


def _prog_header() -> str:
    """reference: vsearch.cc fill_prog_header (:544-556) —
    "<name> v<ver>_<arch>, <ram>GB RAM, <n> cores"."""
    import os
    try:
        pages = os.sysconf("SC_PHYS_PAGES")
        pagesize = os.sysconf("SC_PAGE_SIZE")
        ram_gb = pages * pagesize / (1024.0 ** 3)
    except (ValueError, OSError):
        ram_gb = 0.0
    cores = os.cpu_count() or 1
    return ("%s %s_linux_x86_64, %.1fGB RAM, %d cores"
            % (PROG_NAME, PROG_VERSION, ram_gb, cores))


def show_header(params: Parameters) -> None:
    """reference: vsearch.cc show_header (:573-578)."""
    if params.opt_quiet:
        return
    sys.stderr.write("%s\n" % params.prog_header)
    sys.stderr.write("https://github.com/torognes/vsearch\n")
    sys.stderr.write("\n")


def parse_args(argv: List[str]) -> Parameters:
    params = Parameters()
    params.opt_quiet = False
    params.opt_no_progress = not sys.stderr.isatty()
    params.command_line = " ".join([PROG_NAME] + argv)
    params.prog_header = _prog_header()

    command: Optional[str] = None
    option_seen: Dict[str, bool] = {}

    command_key: Optional[str] = None   # literal option name (matrix row key)

    i = 0
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--"):
            # reference: cli.cc:4001 (extra non-option argument)
            raise CliError("Unrecognized string on command line (%s)" % arg)
        name = arg[2:]
        if name not in OPTION_ARITY:
            # reference: getopt_long_only's own report, then exit(1)
            # (cli.cc:3994-3997); no "Fatal error:" prefix
            sys.stderr.write("%s: unrecognized option '--%s'\n"
                             % (PROG_NAME, name))
            raise SystemExit(1)
        option_seen[name] = True

        def take_value() -> str:
            nonlocal i
            i += 1
            if i >= len(argv):
                # getopt: "option '--X' requires an argument", exit 1
                sys.stderr.write("%s: option '--%s' requires an argument\n"
                                 % (PROG_NAME, name))
                raise SystemExit(1)
            return argv[i]

        def int_value() -> int:
            # reference: args_getlong (cli.cc:392-404)
            try:
                return int(take_value())
            except ValueError:
                raise CliError("Illegal option argument")

        def float_value() -> float:
            # reference: args_getdouble (cli.cc:406-418)
            import math
            try:
                v = float(take_value())
            except ValueError:
                raise CliError("Illegal option argument")
            if not math.isfinite(v):
                raise CliError("Illegal option argument")
            return v

        if name in COMMANDS:
            if command is not None:
                raise CliError("More than one command specified")
            command = name
            command_key = name
            setattr(params, "opt_" + name, take_value())
        elif name in ("help", "h"):
            if command is not None:
                raise CliError("More than one command specified")
            command = "help"
            command_key = name
        elif name in ("version", "v"):
            if command is not None:
                raise CliError("More than one command specified")
            command = "version"
            command_key = name
        elif name in ("band", "hspw", "minhsp", "xdrop_nw"):
            # legacy usearch options, accepted but ignored
            # (reference: cli.cc:3668-3686)
            take_value()
            sys.stderr.write("WARNING: Option --%s is ignored\n" % name)
        elif name == "gapopen":
            parse_gap_penalty_string(take_value(), True, params)
        elif name == "gapext":
            parse_gap_penalty_string(take_value(), False, params)
        elif name == "strand":
            v = take_value()
            if v == "plus":
                params.opt_strand = False
            elif v == "both":
                params.opt_strand = True
            else:
                raise CliError(
                    "The argument to --strand must be plus or both")
        elif name in ("qmask", "dbmask"):
            # invalid values resolve to Masking.error here and are rejected
            # in validate_option_values (reference: cli.cc:3232-3235,4240)
            v = take_value()
            if v in ("none", "dust", "soft"):
                setattr(params, "opt_" + name, Masking[v])
            else:
                setattr(params, "opt_" + name, Masking.error)
        elif name in ("fulldp", "cons_truncate"):
            # no-argument flags, accepted but ignored with a warning
            # (reference: cli.cc:2948-2950, 3277-3279)
            setattr(params, "opt_" + name, 1)
            sys.stderr.write("WARNING: Option --%s is ignored\n" % name)
        elif name == "uchimeout5":
            # no-argument flag (reference: cli.cc:937,3356-3357)
            params.opt_uchimeout5 = 1
        elif name == "userfields":
            from .core.results import parse_userfields
            params.opt_userfields = parse_userfields(take_value())
        elif name == "ee_cutoffs":
            params.opt_ee_cutoffs = [float(x) for x in take_value().split(",")]
        elif name == "length_cutoffs":
            # reference: cli.cc args_get_length_cutoffs (:126-160) —
            # "shortest,longest,increment" with '*' for unbounded longest
            parts = take_value().split(",")
            if len(parts) != 3:
                raise CliError("Invalid arguments to length_cutoffs")
            try:
                params.opt_length_cutoffs_shortest = int(parts[0])
                params.opt_length_cutoffs_longest = (
                    2**31 - 1 if parts[1] == "*" else int(parts[1]))
                params.opt_length_cutoffs_increment = int(parts[2])
            except ValueError:
                raise CliError("Invalid arguments to length_cutoffs")
            if (params.opt_length_cutoffs_shortest < 1
                    or params.opt_length_cutoffs_shortest
                    > params.opt_length_cutoffs_longest
                    or params.opt_length_cutoffs_increment < 1):
                raise CliError("Invalid arguments to length_cutoffs")
        elif name in STR_OPTS:
            setattr(params, "opt_" + name, take_value())
            if name == "join_padgapq":
                # reference: cli.cc:3800-3802
                params.opt_join_padgapq_set_by_user = True
        elif name in INT_OPTS:
            setattr(params, "opt_" + name, int_value())
        elif name in FLOAT_OPTS:
            setattr(params, "opt_" + name, float_value())
        elif name in FLAG_OPTS:
            if name in _INT_FLAGS:
                setattr(params, "opt_" + name, 1)
            else:
                setattr(params, "opt_" + name, True)
        else:
            raise CliError("Unknown option: --%s" % name)
        i += 1

    if command is None:
        # reference: resolve_command (cli.cc:4044-4048) warns, then
        # dispatch falls through to cmd_none (vsearch.cc:798,384)
        if option_seen:
            sys.stderr.write(
                "WARNING: Options given, but no valid command specified.\n")
        params._command = "_none"  # type: ignore[attr-defined]
        return params
    validate_command_options(command_key, option_seen)
    configure_threads(command_key, option_seen, params)
    params._command = command  # type: ignore[attr-defined]
    validate_option_values(option_seen, params)
    apply_command_defaults(option_seen, params)
    return params


def validate_command_options(command_key: str,
                             option_seen: Dict[str, bool]) -> None:
    """Reject options not in the command's allowed set with the reference's
    exact report (cli.cc:4049-4105): invalid options listed in enum
    (alphabetical) order, allowed options in the matrix row order."""
    allowed = set(VALID_OPTIONS[command_key])
    invalid = [n for n in OPTION_ORDER
               if option_seen.get(n) and n != command_key
               and n not in allowed]
    if not invalid:
        return
    out = ["Fatal error: Invalid options to command %s\n" % command_key,
           "Invalid option(s):"]
    out.extend(" --%s" % n for n in invalid)
    out.append("\nThe valid options for the %s command are:" % command_key)
    row = VALID_OPTIONS[command_key]
    out.extend(" --%s" % n for n in row)
    if not row:
        out.append(" (none)")
    out.append("\n")
    sys.stderr.write("".join(out))
    raise SystemExit(1)


def configure_threads(command_key: str, option_seen: Dict[str, bool],
                      params: Parameters) -> None:
    """reference: cli.cc configure_threads (:4112-4148)."""
    import os
    if params.opt_threads < 0 or params.opt_threads > 1024:
        raise CliError(
            "The argument to --threads must be in the range 0 (default) to 1024")
    if command_key in _MT_COMMANDS:
        if params.opt_threads == 0:
            params.opt_threads = os.cpu_count() or 1
    else:
        if params.opt_threads > 1:
            sys.stderr.write(
                "WARNING: The %s command does not support multithreading.\n"
                "Only 1 thread used.\n" % command_key)
        params.opt_threads = 1
    if (command_key == "sintax" and params.opt_randseed != 0
            and params.opt_threads > 1):
        sys.stderr.write(
            "WARNING: Using the --sintax command with the --randseed option "
            "may not work as intended with multiple threads. Use a single "
            "thread (--threads 1) to ensure reproducible results.\n")


def validate_option_values(option_seen: Dict[str, bool],
                           params: Parameters) -> None:
    """Range/consistency checks with reference-exact messages
    (reference: cli.cc validate_option_values :4150-4449).  The weak_id /
    maxrejects / wordlength co-dependent defaults stay in
    apply_command_defaults (they were already handled there)."""
    p = params

    def fail(msg: str) -> None:
        raise CliError(msg)

    if p.opt_iddef < 0 or p.opt_iddef > 4:
        fail("The argument to --iddef must in the range 0 to 4")
    if p.opt_match > 32767 or p.opt_match < -32767:
        fail("The argument to --match must be in the range -32767 to 32767")
    if p.opt_mismatch > 32767 or p.opt_mismatch < -32767:
        fail("The argument to --mismatch must be in the range -32767 to 32767")
    if p.opt_alignwidth < 0:
        fail("The argument to --alignwidth must not be negative")
    if p.opt_rowlen < 0:
        fail("The argument to --rowlen must not be negative")
    if p.opt_qmask == Masking.error:
        fail("The argument to --qmask must be none, dust or soft")
    if p.opt_dbmask == Masking.error:
        fail("The argument to --dbmask must be none, dust or soft")
    if p.opt_sample_pct < 0.0 or p.opt_sample_pct > 100.0:
        fail("The argument to --sample_pct must be in the range 0.0 to 100.0")
    if p.opt_sample_size < 0:
        fail("The argument to --sample_size must not be negative")
    if ((1 if p.opt_relabel is not None else 0) + int(p.opt_relabel_md5)
            + int(p.opt_relabel_self) + int(p.opt_relabel_sha1)) > 1:
        fail("Specify only one of --relabel, --relabel_self, --relabel_sha1, "
             "or --relabel_md5")
    if p.opt_fastq_tail < 1:
        fail("The argument to --fastq_tail must be greater than zero")
    if p.opt_min_unmasked_pct < 0.0 or p.opt_min_unmasked_pct > 100.0:
        fail("The argument to --min_unmasked_pct must be between 0.0 and 100.0")
    if p.opt_max_unmasked_pct < 0.0 or p.opt_max_unmasked_pct > 100.0:
        fail("The argument to --max_unmasked_pct must be between 0.0 and 100.0")
    if p.opt_min_unmasked_pct > p.opt_max_unmasked_pct:
        fail("The argument to --min_unmasked_pct cannot be larger than "
             "--max_unmasked_pct")
    if p.opt_fastq_ascii not in (33, 64):
        fail("The argument to --fastq_ascii must be 33 or 64")
    if p.opt_fastq_qmin > p.opt_fastq_qmax:
        fail("The argument to --fastq_qmin cannot be greater than "
             "--fastq_qmax")
    if p.opt_fastq_ascii + p.opt_fastq_qmin < 33:
        fail("Sum of arguments to --fastq_ascii and --fastq_qmin must be no "
             "less than 33")
    if p.opt_fastq_ascii + p.opt_fastq_qmax > 126:
        fail("Sum of arguments to --fastq_ascii and --fastq_qmax must be no "
             "more than 126")
    if p.opt_fastq_qminout > p.opt_fastq_qmaxout:
        fail("The argument to --fastq_qminout cannot be larger than "
             "--fastq_qmaxout")
    if p.opt_fastq_asciiout not in (33, 64):
        fail("The argument to --fastq_asciiout must be 33 or 64")
    if p.opt_fastq_asciiout + p.opt_fastq_qminout < 33:
        fail("Sum of arguments to --fastq_asciiout and --fastq_qminout must "
             "be no less than 33")
    if p.opt_fastq_asciiout + p.opt_fastq_qmaxout > 126:
        fail("Sum of arguments to --fastq_asciiout and --fastq_qmaxout must "
             "be no more than 126")
    if p.opt_gzip_decompress and p.opt_bzip2_decompress:
        fail("Specify either --gzip_decompress or --bzip2_decompress, "
             "not both")
    query = (p.opt_usearch_global or p.opt_search_exact or p.opt_sintax
             or p.opt_orient or p.opt_uchime_ref)
    if p.opt_db == "-" and query == "-":
        fail("Cannot read both the query and the database from standard "
             "input; give one of them an explicit path such as /dev/stdin, "
             "a named pipe, or a process substitution")
    if p.opt_sintax_cutoff < 0.0 or p.opt_sintax_cutoff > 1.0:
        fail("The argument to sintax_cutoff must be in the range 0.0 to 1.0")
    if p.opt_lca_cutoff <= 0.5 or p.opt_lca_cutoff > 1.0:
        fail("The argument to lca_cutoff must be larger than 0.5, but not "
             "larger than 1.0")
    if p.opt_minuniquesize < 1:
        fail("The argument to minuniquesize must be at least 1")
    if p.opt_maxuniquesize < 1:
        fail("The argument to maxuniquesize must be at least 1")
    if p.opt_maxsize < 1:
        fail("The argument to maxsize must be at least 1")
    if p.opt_maxhits < 0:
        fail("The argument to maxhits cannot be negative")
    if p.opt_chimeras_length_min < 1:
        fail("The argument to chimeras_length_min must be at least 1")
    if p.opt_chimeras_parents_max < 2 or p.opt_chimeras_parents_max > 20:
        fail("The argument to chimeras_parents_max must be in the range "
             "2 to 20.\n")
    if p.opt_chimeras_diff_pct < 0.0 or p.opt_chimeras_diff_pct > 50.0:
        fail("The argument to chimeras_diff_pct must be in the range "
             "0.0 to 50.0")
    if option_seen.get("chimeras_parts") and (
            p.opt_chimeras_parts < 2 or p.opt_chimeras_parts > 100):
        fail("The argument to chimeras_parts must be in the range 2 to 100")
    if p.opt_fasta_width < 0:
        fail("The argument to --fasta_width cannot be negative")
    if p.opt_maxseqlength < 1:
        fail("The argument to --maxseqlength must be a positive integer")
    if p.opt_maxseqlength > 2**31 - 1 - 2001:
        fail("The argument to --maxseqlength cannot exceed %d (INT_MAX - %d)"
             % (2**31 - 1 - 2001, 2001))


def apply_command_defaults(option_seen: Dict[str, bool],
                           params: Parameters) -> None:
    """reference: cli.cc apply_command_defaults (:4451-4522), preceded by the
    co-dependent defaults of validate_option_values (cli.cc:4150-4201) which
    run before the fixups: weak_id (0.90 for unoise, else clamped to opt_id
    even when id is unset), maxrejects (8 for cluster_fast), wordlength."""
    if params.opt_cluster_unoise is not None:
        params.opt_weak_id = 0.90
    elif params.opt_weak_id > params.opt_id:
        params.opt_weak_id = params.opt_id
    if params.opt_maxrejects == -1:
        params.opt_maxrejects = 8 if params.opt_cluster_fast is not None \
            else 32
    if params.opt_wordlength == 0:
        params.opt_wordlength = 12 if params.opt_orient is not None else 8
    params.apply_defaults_fixups()

    if params.opt_minsize == 0:
        params.opt_minsize = 8 if params.opt_cluster_unoise is not None else 1

    # chimeras_denovo narrows the default alignment width (cli.cc:4441-4448)
    if (params.opt_chimeras_denovo is not None
            and not option_seen.get("alignwidth")):
        params.opt_alignwidth = 60

    if not option_seen.get("abskew"):
        if params.opt_chimeras_denovo is not None:
            params.opt_abskew = 1.0
        elif params.opt_uchime3_denovo is not None:
            params.opt_abskew = 16.0
        else:
            params.opt_abskew = 2.0

    if params.opt_minseqlength < 0:
        if any(getattr(params, "opt_" + c) is not None for c in (
                "cluster_fast", "cluster_size", "cluster_smallmem",
                "cluster_unoise", "derep_fulllength", "derep_id",
                "derep_prefix", "makeudb_usearch", "sintax",
                "usearch_global")):
            params.opt_minseqlength = 32
        else:
            params.opt_minseqlength = 1

    if params.opt_sintax is not None:
        params.opt_notrunclabels = True


_CMD_NONE_TEXT = """\
For more help, please enter: %s --help
For further details, please consult the manual by entering: man vsearch

Selected command examples:

vsearch --allpairs_global FILENAME --id 0.5 --alnout FILENAME
vsearch --cluster_size FILENAME --id 0.97 --centroids FILENAME
vsearch --cut FILENAME --cut_pattern G^AATT_C --fastaout FILENAME
vsearch --fastq_chars FILENAME
vsearch --fastq_convert FILENAME --fastqout FILENAME --fastq_ascii 64
vsearch --fastq_eestats FILENAME --output FILENAME
vsearch --fastq_eestats2 FILENAME --output FILENAME
vsearch --fastq_mergepairs FILENAME --reverse FILENAME --fastqout FILENAME
vsearch --fastq_stats FILENAME --log FILENAME
vsearch --fastx_filter FILENAME --fastaout FILENAME --fastq_trunclen 100
vsearch --fastx_getseq FILENAME --label LABEL --fastaout FILENAME
vsearch --fastx_mask FILENAME --fastaout FILENAME
vsearch --fastx_revcomp FILENAME --fastqout FILENAME
vsearch --fastx_subsample FILENAME --fastaout FILENAME --sample_pct 1
vsearch --fastx_uniques FILENAME --fastaout FILENAME
vsearch --makeudb_usearch FILENAME --output FILENAME
vsearch --search_exact FILENAME --db FILENAME --alnout FILENAME
vsearch --sff_convert FILENAME --output FILENAME --sff_clip
vsearch --shuffle FILENAME --output FILENAME
vsearch --sintax FILENAME --db FILENAME --tabbedout FILENAME
vsearch --sortbylength FILENAME --output FILENAME
vsearch --sortbysize FILENAME --output FILENAME
vsearch --uchime_denovo FILENAME --nonchimeras FILENAME
vsearch --uchime_ref FILENAME --db FILENAME --nonchimeras FILENAME
vsearch --usearch_global FILENAME --db FILENAME --id 0.97 --alnout FILENAME

Other commands: cluster_fast, cluster_smallmem, cluster_unoise, cut,
                derep_id, derep_fulllength, derep_prefix, derep_smallmem,
                fasta2fastq, fastq_filter, fastq_join, fastx_getseqs,
                fastx_getsubseq, fastx_syncpairs, maskfasta, orient, rereplicate,
                uchime2_denovo, uchime3_denovo, udb2fasta, udbinfo, udbstats,
                version

"""


def dispatch(params: Parameters) -> None:
    """reference: vsearch.cc dispatch_command (:607-800)."""
    command = params._command  # type: ignore[attr-defined]
    if command == "_none":
        # reference: cmd_none (vsearch.cc:384-427)
        if not params.opt_quiet:
            sys.stderr.write(_CMD_NONE_TEXT % PROG_NAME)
        return
    if command == "version":
        # reference: vsearch.cc cmd_version → show_publication + build info
        if not params.opt_quiet:
            sys.stdout.write(_PUBLICATION)
            sys.stdout.write(
                "PyTorch/CUDA reimplementation; gzip and "
                "bzip2 compressed files supported.\n")
        return
    if command == "help":
        # reference: commands/help.cpp help() — publication, usage, then the
        # option surface.  Ours is generated from the live option tables.
        if not params.opt_quiet:
            sys.stdout.write(_PUBLICATION)
            sys.stdout.write("Usage: %s [OPTIONS]\n\n" % PROG_NAME)
            sys.stdout.write("Commands (exactly one per invocation):\n")
            for cmd in COMMANDS:
                sys.stdout.write("  --%s FILENAME\n" % cmd)
            sys.stdout.write("  --help | --version\n\n")
            sys.stdout.write("Options (reference-compatible surface):\n")
            names = sorted(set(STR_OPTS + INT_OPTS + FLOAT_OPTS + FLAG_OPTS)
                           | {"strand", "userfields", "gapopen", "gapext",
                              "qmask", "dbmask", "ee_cutoffs",
                              "length_cutoffs"})
            col = 0
            for name in names:
                tok = "--" + name
                if col + len(tok) + 1 > 78:
                    sys.stdout.write("\n")
                    col = 0
                sys.stdout.write(" " + tok)
                col += len(tok) + 1
            sys.stdout.write("\n\nSee the vsearch manual for option "
                             "semantics; this implementation mirrors them.\n")
        return
    if command == "allpairs_global":
        # reference: dispatch forces single strand + uc_allhits
        # (vsearch.cc:613-617)
        params.opt_strand = False
        params.opt_uc_allhits = True
        from .commands.allpairs import allpairs_global
        allpairs_global(params)
        return
    if command == "usearch_global":
        from .commands.usearch_global import usearch_global
        usearch_global(params)
    elif command in ("derep_fulllength", "derep_id", "fastx_uniques"):
        from .commands.derep import derep
        derep(params, command)
    elif command == "derep_prefix":
        from .commands.derep import derep_prefix
        derep_prefix(params)
    elif command == "derep_smallmem":
        from .commands.derep import derep_smallmem
        derep_smallmem(params)
    elif command == "sortbysize":
        from .commands.sort import sortbysize
        sortbysize(params)
    elif command == "sortbylength":
        from .commands.sort import sortbylength
        sortbylength(params)
    elif command == "shuffle":
        from .commands.sort import shuffle
        shuffle(params)
    elif command in ("cluster_fast", "cluster_size", "cluster_smallmem",
                     "cluster_unoise"):
        from .commands.cluster import cluster_command
        cluster_command(params, command)
    elif command in ("uchime_denovo", "uchime2_denovo", "uchime3_denovo",
                     "uchime_ref", "chimeras_denovo"):
        from .commands.chimera import chimera_command
        chimera_command(params, command)
    elif command == "fastq_mergepairs":
        from .commands.mergepairs import fastq_mergepairs
        fastq_mergepairs(params)
    elif command in ("fastq_filter", "fastx_filter"):
        from .commands.filter import filter_command
        filter_command(params, command)
    elif command == "search_exact":
        from .commands.search_exact import search_exact
        search_exact(params)
    elif command == "fastx_mask":
        from .commands.fastx_ops import fastx_mask
        fastx_mask(params)
    elif command == "maskfasta":
        from .commands.fastx_ops import maskfasta
        maskfasta(params)
    elif command == "fastx_revcomp":
        from .commands.fastx_ops import fastx_revcomp
        fastx_revcomp(params)
    elif command == "fastx_subsample":
        from .commands.fastx_ops import fastx_subsample
        fastx_subsample(params)
    elif command == "rereplicate":
        from .commands.fastx_ops import rereplicate
        # reference: dispatch forces xsize for rereplicate (vsearch.cc:737)
        params.opt_xsize = True
        rereplicate(params)
    elif command == "sintax":
        from .commands.sintax import sintax
        sintax(params)
    elif command == "orient":
        from .commands.orient import orient
        orient(params)
    elif command == "fastq_convert":
        from .commands.convert import fastq_convert
        fastq_convert(params)
    elif command == "fasta2fastq":
        from .commands.convert import fasta2fastq
        fasta2fastq(params)
    elif command == "fastq_join":
        from .commands.convert import fastq_join
        fastq_join(params)
    elif command == "fastx_syncpairs":
        from .commands.convert import fastx_syncpairs
        fastx_syncpairs(params)
    elif command == "fastq_chars":
        from .commands.stats import fastq_chars
        fastq_chars(params)
    elif command == "fastq_stats":
        from .commands.stats import fastq_stats
        fastq_stats(params)
    elif command == "fastq_eestats":
        from .commands.stats import fastq_eestats
        fastq_eestats(params)
    elif command == "fastq_eestats2":
        from .commands.stats import fastq_eestats2
        fastq_eestats2(params)
    elif command in ("fastx_getseq", "fastx_getseqs", "fastx_getsubseq"):
        from .commands.getseq import getseq
        getseq(params, command)
    elif command == "cut":
        from .commands.cut import cut
        cut(params)
    elif command == "sff_convert":
        from .commands.sff import sff_convert
        sff_convert(params)
    elif command == "makeudb_usearch":
        from .commands.udb_cmds import makeudb_usearch
        makeudb_usearch(params)
    elif command == "udb2fasta":
        from .commands.udb_cmds import udb2fasta
        udb2fasta(params)
    elif command == "udbinfo":
        from .commands.udb_cmds import udbinfo
        udbinfo(params)
    elif command == "udbstats":
        from .commands.udb_cmds import udbstats
        udbstats(params)
    else:
        raise CliError("Command %s not implemented yet" % command)


def main(argv: Optional[List[str]] = None,
         device: Optional[str] = None) -> int:
    """Run one command.  ``device`` names the torch device of the device
    tier ("cuda" unless given; "cpu" runs the kernels' plain versions);
    without it the VSEARCH_TPU_TORCH_DEVICE environment variable decides.
    Under torchrun (WORLD_SIZE above 1) every rank runs the command over
    its shard of the device state, and rank 0 writes the outputs
    (parallel/distributed.py)."""
    from .parallel import distributed
    # a process group from torchrun's environment: before any device use
    distributed.maybe_initialize(device=device)
    distributed.select_device(device)
    if argv is None:
        argv = sys.argv[1:]
    params: Optional[Parameters] = None
    fp_log = None
    try:
        params = parse_args(argv)
        show_header(params)
        if params.opt_log is not None:
            # reference: utils/logfile.cpp LogFile — header, Started/Finished
            # timestamps, elapsed time and peak memory bracket the report
            import resource
            import time
            fp_log = open(distributed.output_path(params.opt_log), "wb")
            params.fp_log = fp_log
            stamp = time.strftime("%Y-%m-%dT%H:%M:%S")
            fp_log.write(params.prog_header.encode() + b"\n")
            fp_log.write(params.command_line.encode() + b"\n")
            fp_log.write(b"Started  %s\n" % stamp.encode())
            t0 = time.monotonic()
        dispatch(params)
        # deferred stdout write errors (vsearch ... | head): reference
        # checks at end of main (vsearch.cc:843-852)
        from .io.openfile import check_stdout
        check_stdout()
        if fp_log is not None:
            # footer only on success: fatal() exits without running the
            # LogFile destructor in the reference (std::exit skips locals)
            dt = time.monotonic() - t0
            stamp = time.strftime("%Y-%m-%dT%H:%M:%S")
            fp_log.write(b"\nFinished %s\n" % stamp.encode())
            fp_log.write(b"Elapsed time %02.0f:%02.0f\n"
                         % (dt // 60, dt % 60))
            maxmem = resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 1024.0
            if maxmem < 1024.0:
                fp_log.write(b"Max memory %.1fMB\n" % maxmem)
            else:
                fp_log.write(b"Max memory %.1fGB\n" % (maxmem / 1024.0))
            fp_log.close()
    except SystemExit as exc:
        # pre-formatted CLI reports (invalid-option matrix, getopt-style
        # unrecognized option) already wrote their message; string payloads
        # (pre-formatted fatal texts from deep pipelines) print like the
        # interpreter would and exit 1
        if isinstance(exc.code, str):
            sys.stderr.write(exc.code if exc.code.endswith("\n")
                             else exc.code + "\n")
            return 1
        return int(exc.code or 0)
    except (CliError, ValueError, OSError) as exc:
        # reference: utils/fatal.cpp:68-79 — "\n\nFatal error: <message>\n"
        # on stderr, duplicated to the log file, exit 1
        text = "\n\nFatal error: %s\n" % exc
        sys.stderr.write(text)
        if fp_log is not None and not fp_log.closed:
            fp_log.write(text.encode())
            fp_log.close()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
