#!/usr/bin/env python3
"""Smoke run of vsearch_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Seven main paths: usearch_global (kernels K1, K2, K3), greedy
clustering (K4, K2, K3), allpairs_global (K2m, K5), usearch_global
under --mismatch -200, a mismatch score outside int8 that routes the
alignments to the wavefront forward and the flat backtrack (K1, K6, K7),
de novo chimera detection (K4, and K2, K3 where its alignment waves
pass the host crossover; its parity runs also drive uchime_ref's K1 and
K6, K7 under --mismatch -200), and the session API's
SearchSession.search_batch (K1, K2, K3; its parity runs also drive
ChimeraSession's K1); the C-ABI embedding shim, a C program's
vstpu_search_single calls (K1, K2, K3); and the multi-process path, two
torch.distributed ranks sharing the card, each running the kernels of
its shard (K1, K4, K2 + K3, K6 + K7).
Phases (any failure ends the run with a non-zero exit and no result
line):

1. build the CUDA kernels of csrc/ with nvcc (one process per source, all
   started together) and print the build seconds and ptxas's register
   counts;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes its main path gives it (exact equality: the work is integer
   counts and integer DP), and time kernel, plain version, one PyTorch
   library call computing the same function where there is one, and the
   least time the card could take (bound_ms): K1, K2 and K3 at the search
   shapes, K1 at a single query's (the chunk of 128 that each
   vstpu_search_single call scores, the bench's first query) and K2 and
   K3 at a walk round's (the first 128 of those pairs,
   BatchAligner.PAIR_BUCKETS[0]; K3 also timed right after a fresh K2
   launch wrote its plane, ms_after_k2, as the pipeline runs it, beside
   its entries a lane, max_steps and mean_steps), K4 at the full
   clustering width (the index's capacity, 3200 words) and at the
   filled prefix its top-k scans (896 words at the cell's 25 000
   centroids), K2 and K3 at the
   cluster prefetch's shape, K2m and K5 on the allpairs cell's first
   batch (W=400, B=4096; K2m's 16-bit body as routed and its 32-bit body
   through a private argument of the wrapper, each against the plain
   version and timed in turns, and against each other on three later
   batches; K5 also right after a fresh K2m launch wrote its
   planes, ms_after_k2m, beside its entries a lane and the windows a
   lane that window_rounds models), K6 and
   K7 under --mismatch -200 on the search prefetch's top-1 pairs (B=512,
   M=N=640), on a walk round's (the first 128 of them) and on the cluster
   round's top-1 pairs (B=512, M=N=512), each beside K2's time on the
   same pairs under the default scheme (K7 also right after a fresh K6
   launch wrote its plane, ms_after_k6, beside its moves a lane and the
   windows a lane that its counted build fetched on the same inputs);
3. run usearch_global through the CLI on two small workloads, four
   option sets each (the fourth with --mismatch -200): on cuda as routed,
   on cuda with every walk round forced onto the device aligner, and on
   cpu (the plain versions); uc and blast6 must be byte-equal, and the
   launches of each cuda run are printed, the walk rounds' forward
   launches apart from the prefetch's; then four clustering runs of a
   small family workload (the fourth --cluster_fast --mismatch -200) with
   the device tier from the 16th centroid on, on cuda and on cpu, uc and
   centroids byte-equal; then allpairs_global on 48 sequences with seven
   option sets, on cuda and on cpu, every output byte-equal, K2m and K5
   launched on the stats pipeline's six (one with --match 220, where
   some pairs overflow the 16-bit forward and K2m takes its 32-bit body,
   the others its 16-bit body; one with --minsl 0.8, where
   the unaligned gate filters pairs) and not on --acceptall (the generic
   path); then the five chimera verbs on a seeded 800-sequence
   workload (tests/chimera_workload.py; chimeras_denovo also with
   tests/data/chimeras_long.fasta
   appended), uchime_ref against 520 references and uchime3_denovo
   --mismatch -200, with the de novo device tier from the 16th accepted
   reference on, on cuda with every alignment call on the device aligner
   and on cpu, every output byte-equal, each cuda run launching K4 (K1
   for uchime_ref).  The --mismatch -200 runs must launch K6 and K7 and
   no K2, K3 or plain version; every other run no K6 or K7.  Then the
   session API (tests/api_sessions.py) on cuda and on cpu, results equal
   as JSON: SearchSession.search on each of write_parity_workload's 64
   queries and search_batch on all 64 against its 520 references (cuda:
   K1, K2 and K3), ChimeraSession.detect on the chimera workload's
   queries against its 520 references (cuda: K1) and
   ClusterSession.assign over a small family set sorted by length; then
   the amplicon workflow of tests/amplicon_workload.py on 4000 seeded
   pairs (--fastq_mergepairs, --fastq_filter --fastq_maxee 1,
   --fastx_uniques, --cluster_unoise, --uchime3_denovo, --usearch_global
   --otutabout, --sintax, each step's outputs feeding the next) on cuda
   and on cpu, every step's outputs byte-equal, with each step's
   seconds and the device steps' launches; then the multi-block merge:
   usearch_global of 64 queries against 270 000 sequences of 64 nt,
   three index blocks of DeviceKmerIndex.BLOCK_POS positions, on cuda
   (K1 once a block) and on cpu, uc and blast6 byte-equal; then
   --match 1 --mismatch 100 (tests/overflow_workload.py, 400-520 nt, a
   mismatch reward that takes alignments past SHRT_MAX): usearch_global
   with every walk round on the device aligner and allpairs_global, on
   cuda and on cpu, uc, blast6 and userout byte-equal, each cuda run
   flagging overflowing pairs (K1, K2, K3; K2m's 32-bit body and K5); the
   inputs of the first K2 call and the first K2m call of the cuda runs in
   which a pair overflowed are kept, and K2 and K2m on them (overflow
   tracking on) and K3 on K2's plane are held against their plain
   versions;
4. the full-width runs.  usearch_global: the bench dataset (100 000 DB
   sequences x 600 nt, 2000 queries, seed 1234, --id 0.9 --maxaccepts 1
   --maxrejects 32, wordlength 8) through the CLI, one warm-up then one
   timed run, with the launch counts of every kernel read around the timed
   run, then the same run under torch.profiler for the device's busy time
   by kernel and its idle share.  Clustering: tools/bench_scale.py's
   amp100k cell (25 000 families x 4 members x 400 nt, seed 17) through
   --cluster_size --id 0.97 --sizein --sizeout, one timed run with the
   launch counts read around it, then the same run under torch.profiler
   with K4's device ms per launch and the mean words a launch scans, and
   K3's device ms with the fills that zero its ops.
   Allpairs: tools/bench_scale.py's allpairs_2000 cell (2000 random
   400 nt sequences, seed 17, 1 999 000 pairs) through --allpairs_global
   --id 0.5 --blast6out, timed runs in turns as routed (K2m's 16-bit
   body once a batch), through its 32-bit body and as routed again, with
   the launch counts and the pipeline's pair counts read around each and
   every blast6 byte-equal, its first 64 sequences on cuda and on cpu,
   byte-equal, then the routed run under torch.profiler.  usearch_global under --mismatch -200: the bench
   dataset again, one warm-up, one timed run with the launch counts, one
   traced run.  Chimera: tools/bench_scale.py's uchime3_denovo_50k cell
   (12 500 families x 4 members x 400 nt, seed 17) through
   --uchime3_denovo --chimeras --nonchimeras --borderline, one timed run
   with the launch counts read around it (every input in exactly one
   output), then the same run under torch.profiler with K4's device ms a
   launch, then K4 against its plain version on that run's largest chunk
   and K2 and K3 on the timed run's largest alignment wave (its largest
   alignment call, sent to the card, where no wave passed the
   crossover).  The session API: a SearchSession over the bench dataset
   (FULL_ARGS), search_batch on its 2000 queries as one batch, once to
   warm up, once timed with the launch counts read around it, four times
   more timed, once under torch.profiler; a result row a query, each equal in target and CIGAR
   to the usearch_global run's uc line.  The C-ABI shim ("capi"):
   vsearch_tpu_torch/capi.py builds csrc/capi.c and the demo embedder
   csrc/capi_demo.c; the demo, a subprocess on the card, sends the bench
   dataset's first CAPI_QUERIES queries, one vstpu_search_single call
   each, its rows equal to SearchSession.search's in this process; the
   shim loaded into this process with ctypes sends the same queries, each
   call timed, with the launch counts read around that run, which is the
   path's in the kernels line: its rows equal the demo's, its queries/s
   and the median and p99 of a call are printed with the demo's wall; on
   write_parity_workload the demo on cuda and on cpu and the two-thread
   embedder tests/capi_threads.c print the same rows; the shim in this
   process drives vstpu_* on the same workload,
   from this thread and from a new one, each launching K1, K2 and K3 and
   no plain version.  Before each full-width run the
   aligner's process-wide routing estimates are set back to where a
   fresh CLI process starts, and the host/device crossover (DP cells) and
   the walk rounds that reached the device forward are printed;
5. the sharded path: tests/parallel_driver.py under torchrun, two ranks
   on the one card over gloo (nccl refuses two ranks on one card), runs
   the search cell (after a warm-up), the chimera and the clustering
   cells as routed, and at phase 3's sizes with every alignment call on
   the card the families' --mismatch -200 search, uchime_ref and the
   multi-block search (two blocks a rank), each under torch.profiler.
   Every output must be byte-equal to the single-process cuda run's; in
   each rank the path's kernels must launch (K1 twice a rank on the
   multi-block DB), no plain version run, the sharded index be built and
   collectives run, and neither jax nor vsearch_tpu be loaded.  Each
   run's seconds, launches, collectives and idle share are printed by
   rank: two ranks on one card measure function, not scaling;
6. the script's total seconds, and one line listing every kernel with its
   numbers and its launches on each path.

The last line is {"ok": true, "device": {...}}.  Needs one CUDA device;
exits non-zero without one.  Imports nothing of jax or vsearch_tpu.
"""

import functools
import json
import os
import pathlib
import random
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
WORK = REPO / "build" / "vsearch_tpu_torch" / "smoke"

# published H100 SXM peaks (dense): HBM bytes/s and int8 tensor ops/s
HBM_BPS = 3.35e12
INT8_TC_OPS = 1979e12
# integer operations outside the tensor cores: an SM's integer pipes take
# 64 lanes of an instruction a clock (tools/int_rate.py: IADD3, VIMNMX,
# LOP3, PRMT, IMAD and SHF alike), and the three-input forms do two
# operations each (IADD3 two adds, VIMNMX3 two maxes, VIADDMNMX an add
# and a max), as an FMA does two float operations: chained adds and
# min/max complete at 128 lanes an SM a clock there.  So the integer
# operation rate is 128 x the SMs x the maximum SM clock, read from the
# card by int_ops
INT_LANES_PER_SM = 128
# (SMs, maximum SM clock in Hz) of the card, read once
_CARD_CLOCK = None
# int32 operations of one K2 cell update (csrc/nw_rowscan.cu inner loop)
NW_CELL_OPS = 20
# pairs the counted K7 build (flat_windows) counts windows for
COUNTED_PAIRS = 8192

# the bench dataset (bench.py: DB_SIZE, N_QUERIES, SEQ_LEN)
DB_SIZE = 100000
N_QUERIES = 2000
SEQ_LEN = 600

FULL_ARGS = ["--id", "0.9", "--maxaccepts", "1", "--maxrejects", "32",
             "--threads", "1", "--quiet"]

# the clustering cell: tools/bench_scale.py's amp100k (gen_amp_families,
# 25 000 families x 4 members x 400 nt), generated here from its own seed
AMP_FAMILIES = 25000
AMP_LEN = 400
AMP_SEED = 17
CLUSTER_ARGS = ["--id", "0.97", "--sizein", "--sizeout", "--threads", "1",
                "--quiet"]

# the allpairs cell: tools/bench_scale.py's allpairs_2000 (gen_fasta,
# 2000 uniform random ACGT sequences x 400 nt), generated here from its own
# seed; 1 999 000 pairs, 3.2e11 DP cells
AP_SEQS = 2000
AP_LEN = 400
AP_SEED = 17
AP_ARGS = ["--id", "0.5", "--threads", "1", "--quiet"]

# the chimera cell: tools/bench_scale.py's uchime3_denovo_50k
# (gen_amp_families, 12 500 families x 4 members x 400 nt), generated here
# from its own seed as the clustering cell is
CHIM_FAMILIES = 12500
CHIM_ARGS = ["--threads", "1", "--quiet"]

# a mismatch score outside int8: the aligner's codes wire (K6 + K7)
MISMATCH_200 = ["--mismatch", "-200"]

# timed search_batch calls of the session API's full-width run
API_REPS = 5

# the multi-block merge: more positions than two of
# DeviceKmerIndex.BLOCK_POS (131 072), so that one process scores three
# blocks and each of two ranks two; short sequences keep the cpu run cheap
MB_DB = 270000
MB_LEN = 64
MB_QUERIES = 64
MB_ARGS = ["--id", "0.9", "--maxaccepts", "1", "--maxrejects", "32",
           "--threads", "1", "--quiet"]

# the sharded phase: two ranks on the one card, over gloo (nccl refuses
# two ranks on one card), through tests/parallel_driver.py
SHARDED_RANKS = 2
SHARDED_TIMEOUT = 600
# runs done once untraced first, as phase 4's search cell: the second
# run finds its index resident
SHARDED_WARM = ("sharded_usearch_global",)
SHARDED_SETUP = ("from vsearch_tpu_torch.ops.nw_batch import BatchAligner\n"
                 "ROUTER = (BatchAligner._native_cells_crossover,\n"
                 "          BatchAligner._dev_overhead_ema,\n"
                 "          BatchAligner._native_rate_ema)\n")
# the routing estimates a fresh process starts with
SHARDED_FRESH = ("BatchAligner._native_cells_crossover, "
                 "BatchAligner._dev_overhead_ema, "
                 "BatchAligner._native_rate_ema = ROUTER\n")
# every alignment call on the card, as phase 3's forced runs
SHARDED_FORCED = "BatchAligner._native_cells_crossover = lambda self: 0\n"

# the kernels each main path must launch
SEARCH_KERNELS = ("score_dense", "nw_rowscan", "nw_backtrack")
CLUSTER_KERNELS = ("score_ranked", "nw_rowscan", "nw_backtrack")
ALLPAIRS_KERNELS = ("nw_rowscan_mr16", "nw_stats")
SEARCH_200_KERNELS = ("score_dense", "nw_wavefront", "nw_backtrack_flat")
# the alignment kernels of each wire
ROW_WIRE = ("nw_rowscan", "nw_backtrack")
CODES_WIRE = ("nw_wavefront", "nw_backtrack_flat")
# int32 operations of one K2m cell update (K2's and the match plane's)
NW_MR_CELL_OPS = 25
# K2m's two bodies: 16-bit (two pairs a warp) where nw_rowscan.rowscan16
# holds, as on the allpairs cell; 32-bit elsewhere (--match 220)
K2M_BODIES = ("nw_rowscan_mr16", "nw_rowscan_mr")
# sequences of the allpairs cell run also on cpu, cuda against cpu
AP_CPU_SEQS = 64

# the capi phase: the demo's subprocess time limit, and the bench
# dataset's queries it sends, each one vstpu_search_single call: the
# first 512 of the 2000 (with all 2000 the phase took over a minute on an
# H100 80GB HBM3 at 700 W: 12.2 s of calls, and 18.6 s in process)
CAPI_TIMEOUT = 300
CAPI_QUERIES = 512

# BatchAligner's routing estimates (device call overhead, host cell rate)
# as a fresh process starts with them; main() reads them before any run
ROUTER_START = None


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def require(ok, what: str) -> None:
    """Fail the run (a check that, unlike assert, -O does not remove)."""
    if not ok:
        raise RuntimeError("chip_smoke: " + what)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def timed(fn, reps: int) -> float:
    """Milliseconds per call on the card (CUDA events, after a warm-up).
    A sleep kernel queued first (~0.1 ms a call) lets the host queue every
    call before the first starts, so a call shorter than its own launch
    cost on the host is timed on the card, not at the host's launch rate."""
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000 * reps)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def timed_after(first, then, reps: int) -> float:
    """Milliseconds per call of then(first()) on the card, from events
    around then alone: then runs right after first, on its fresh output
    (after a warm-up)."""
    import torch
    then(first())
    total = 0.0
    for _ in range(reps):
        x = first()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        then(x)
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def int_ops(fits16: bool = False) -> float:
    """Integer lane operations/s of the card: INT_LANES_PER_SM x its SMs
    x its maximum SM clock (nvidia-smi clocks.max.sm); twice that where the
    function's values fit 16 bits, two halves a lane (the 16x2 DPX and
    SIMD forms), which is the least time the card could take."""
    import torch
    global _CARD_CLOCK
    if _CARD_CLOCK is None:
        mhz = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True).stdout.split()[0]
        _CARD_CLOCK = (torch.cuda.get_device_properties(0)
                       .multi_processor_count, float(mhz) * 1e6)
    sms, hz = _CARD_CLOCK
    return INT_LANES_PER_SM * sms * hz * (2 if fits16 else 1)


def walk_fits16(M: int, N: int) -> bool:
    """A backtrack's values (coordinates below M + N, run counts up to
    4095, stats up to M + N) fit 16 bits."""
    return M + N <= 32767


def bound(nbytes: float, ops: float, ops_rate: float):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the bytes over the HBM rate and the operations over their peak."""
    t_bytes, t_ops = nbytes / HBM_BPS, ops / ops_rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def crossover(argv) -> float:
    """The aligner's host/device crossover, in DP cells, for the scheme of
    a command line, from its current routing estimates."""
    import torch
    from vsearch_tpu_torch import cli
    from vsearch_tpu_torch.ops.nw import ScoreScheme
    from vsearch_tpu_torch.ops.nw_batch import BatchAligner
    scheme = ScoreScheme.from_params(cli.parse_args(argv))
    return BatchAligner(scheme, torch.device("cuda"))._native_cells_crossover()


def fresh_router(argv) -> float:
    """Set the aligner's process-wide routing estimates to ROUTER_START, so
    the next run routes as a fresh CLI process would; returns the crossover
    that gives for argv."""
    from vsearch_tpu_torch.ops.nw_batch import BatchAligner
    BatchAligner._dev_overhead_ema, BatchAligner._native_rate_ema = \
        ROUTER_START
    return crossover(argv)


def require_wire(launches, codes: bool, what: str) -> None:
    """A run's alignments went through one wire: K6 and K7 and neither K2
    nor K3 under --mismatch -200 (codes), no K6 or K7 otherwise."""
    if codes:
        require(all(launches[k] > 0 for k in CODES_WIRE),
                "K6 or K7 did not launch (%s)" % what)
        require(not any(launches[k] for k in ROW_WIRE),
                "K2 or K3 launched under --mismatch -200 (%s)" % what)
    else:
        require(not any(launches[k] for k in CODES_WIRE),
                "K6 or K7 launched on the row wire (%s)" % what)


def mismatch_200_key(key) -> tuple:
    """The aligner's scheme key with the mismatch score of MISMATCH_200."""
    key = tuple(int(v) for v in key)
    return (key[0], int(MISMATCH_200[1])) + key[2:]


def max_abs_err(a, b) -> int:
    import torch
    if a.dtype == torch.bool:
        return int((a != b).sum())
    if a.dtype == torch.uint16:
        a = a.view(torch.int16).to(torch.int32) & 0xFFFF
        b = b.view(torch.int16).to(torch.int32) & 0xFFFF
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def generate(workdir: pathlib.Path, db_size=DB_SIZE, n_queries=N_QUERIES,
             seq_len=SEQ_LEN):
    """The bench dataset (bench.py generate, seed 1234): random ~600 nt DB
    sequences, queries mutated from DB members at ~95% identity."""
    import numpy as np
    rng = np.random.default_rng(1234)
    db_path = workdir / "db.fasta"
    q_path = workdir / "queries.fasta"
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    codes = rng.integers(0, 4, size=(db_size, seq_len), dtype=np.int8)
    chars = alphabet[codes]
    with open(db_path, "wb") as fh:
        ROW = 8192
        for base in range(0, db_size, ROW):
            hi = min(base + ROW, db_size)
            fh.write(b"".join(b">db%d\n%s\n" % (i, chars[i].tobytes())
                              for i in range(base, hi)))
    with open(q_path, "wb") as fh:
        srcs = rng.integers(0, db_size, size=n_queries)
        nmut = int(seq_len * 0.05)
        for i in range(n_queries):
            seq = list(chars[srcs[i]].tobytes().decode())
            pos = rng.integers(0, seq_len, size=nmut)
            r = rng.random(nmut)
            sub = alphabet[rng.integers(0, 4, size=nmut)]
            for j in range(nmut):
                p = int(pos[j]) % len(seq)
                if r[j] < 0.9:
                    seq[p] = chr(sub[j])
                elif r[j] < 0.95 and len(seq) > 10:
                    del seq[p]
                else:
                    seq.insert(p, chr(sub[j]))
            fh.write(b">q%d\n%s\n" % (i, "".join(seq).encode()))
    return db_path, q_path


def generate_amp(path: pathlib.Path, families=AMP_FAMILIES,
                 length=AMP_LEN, seed=AMP_SEED):
    """tools/bench_scale.py gen_amp_families: per family a random ancestor
    and 4 members, the first a copy of it and the others with up to 9
    random substitutions, each with a random ;size= abundance 1-49."""
    import numpy as np
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    with open(path, "wb") as fh:
        i = 0
        for _ in range(families):
            base = alphabet[rng.integers(0, 4, size=length)]
            for m in range(4):
                s = base.copy()
                pos = rng.integers(0, length,
                                   size=rng.integers(0, 10 if m else 1))
                s[pos] = alphabet[rng.integers(0, 4, size=pos.size)]
                fh.write(b">s%d;size=%d\n%s\n"
                         % (i, rng.integers(1, 50), s.tobytes()))
                i += 1
    return path


def generate_ap(path: pathlib.Path, n=AP_SEQS, length=AP_LEN,
                seed=AP_SEED):
    """tools/bench_scale.py gen_fasta: n uniform random ACGT sequences of
    one length, labelled s0, s1, ..."""
    import numpy as np
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    chars = alphabet[rng.integers(0, 4, size=(n, length), dtype=np.int8)]
    with open(path, "wb") as fh:
        fh.write(b"".join(b">s%d\n%s\n" % (i, chars[i].tobytes())
                          for i in range(n)))
    return path


def write_pairs_workload(path: pathlib.Path):
    """tests/test_allpairs_fast.py's 48 sequences (seed 21, 120-220 nt,
    with N's): half of them mutated copies of one 180 nt base, half
    random."""
    import numpy as np
    rng = np.random.default_rng(21)
    base = rng.choice(list("ACGT"), size=180)
    with open(path, "w") as fh:
        for i in range(48):
            if i % 2 == 0:
                s = base.copy()
                idx = rng.integers(0, 180, size=rng.integers(5, 40))
                s[idx] = rng.choice(list("ACGTN"), size=idx.size)
                s = s[:int(rng.integers(150, 181))]
            else:
                s = rng.choice(list("ACGTN"), size=int(
                    rng.integers(120, 220)), p=[.24, .24, .24, .24, .04])
            fh.write(">p%d;size=%d\n%s\n"
                     % (i, rng.integers(1, 9), "".join(s)))
    return path


def write_cluster_workload(workdir: pathlib.Path, families=200, members=4,
                           seq_len=150, seed=5):
    """Small clustering workload in the form of tests/test_device_growing.py's
    families: 200 random 150 nt ancestors x 4 members with up to 7
    substitutions and random abundances, 800 sequences.  With the device
    tier from the 16th centroid on, a run has one host round of 256 and
    two device rounds, the second carrying the first's new centroids."""
    import numpy as np
    rng = np.random.default_rng(seed)
    path = workdir / "cfam.fasta"
    with open(path, "w") as fh:
        i = 0
        for _ in range(families):
            base = rng.choice(list("ACGT"), size=seq_len)
            for m in range(members):
                s = base.copy()
                for _ in range(int(rng.integers(0, 8 if m else 1))):
                    s[rng.integers(0, seq_len)] = rng.choice(list("ACGT"))
                fh.write(">s%d;size=%d\n%s\n"
                         % (i, int(rng.integers(1, 50)), "".join(s)))
                i += 1
    return path


def read_fasta(path: pathlib.Path):
    """Sequences of a two-line-per-record FASTA file."""
    with open(path, "rb") as fh:
        return fh.read().split(b"\n")[1::2]


def write_parity_workload(workdir: pathlib.Path, db_n=520, n_queries=64,
                          seq_len=150, seed=77):
    """Small usearch_global workload (520 x 150 nt DB, 64 queries at ~92%
    identity): large enough to engage the device index and prefetch."""
    rng = random.Random(seed)
    db = workdir / "pdb.fasta"
    q = workdir / "pq.fasta"
    seqs = []
    with open(db, "w") as fh:
        for i in range(db_n):
            s = "".join(rng.choice("ACGT") for _ in range(seq_len))
            seqs.append(s)
            fh.write(">d%d\n%s\n" % (i, s))
    with open(q, "w") as fh:
        for i in range(n_queries):
            s = list(seqs[rng.randrange(db_n)])
            for _ in range(int(len(s) * 0.08)):
                p = rng.randrange(len(s))
                r = rng.random()
                if r < 0.85:
                    s[p] = rng.choice("ACGT")
                elif r < 0.93 and len(s) > 20:
                    del s[p]
                else:
                    s.insert(p, rng.choice("ACGT"))
            fh.write(">q%d\n%s\n" % (i, "".join(s)))
    return db, q


def write_family_workload(workdir: pathlib.Path, families=52, members=10,
                          n_queries=64, seq_len=150, seed=78):
    """A DB of sequence families (52 random 150 nt ancestors, 10 members
    each at ~95% identity to it) and 64 queries mutated from members: every
    query has several candidates, so its walk asks for alignment rounds
    beyond the top-1 prefetch."""
    rng = random.Random(seed)
    db = workdir / "fdb.fasta"
    q = workdir / "fq.fasta"

    def mutate(seq, rate):
        s = list(seq)
        for _ in range(int(len(s) * rate)):
            p = rng.randrange(len(s))
            r = rng.random()
            if r < 0.85:
                s[p] = rng.choice("ACGT")
            elif r < 0.93 and len(s) > 20:
                del s[p]
            else:
                s.insert(p, rng.choice("ACGT"))
        return "".join(s)

    seqs = []
    for _ in range(families):
        anc = "".join(rng.choice("ACGT") for _ in range(seq_len))
        seqs.extend(mutate(anc, 0.05) for _ in range(members))
    with open(db, "w") as fh:
        for i, s in enumerate(seqs):
            fh.write(">f%d\n%s\n" % (i, s))
    with open(q, "w") as fh:
        for i in range(n_queries):
            fh.write(">fq%d\n%s\n" % (i, mutate(rng.choice(seqs), 0.05)))
    return db, q


def fasta_heads(path: pathlib.Path):
    """Headers of a FASTA file (wrapped or not), without the '>'."""
    return [ln[1:] for ln in path.read_bytes().split(b"\n")
            if ln.startswith(b">")]


def counted_so():
    """The counted build of csrc/nw_backtrack.cu: K7 as shipped, also
    counting the windows each pair fetches (K7_COUNT_WINDOWS)."""
    from vsearch_tpu_torch.ops import cuda_lib
    return cuda_lib.BUILD_DIR / "libnw_backtrack_counted.so"


def phase_build(gpu):
    from vsearch_tpu_torch.ops import cuda_lib
    t0 = time.perf_counter()
    cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    counted = subprocess.Popen(
        [cuda_lib._nvcc()] + cuda_lib.NVCC_FLAGS
        + ["-DK7_COUNT_WINDOWS=%d" % COUNTED_PAIRS, "-o", str(counted_so()),
           str(cuda_lib.CSRC / "nw_backtrack.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        built = cuda_lib.build(force=True)
    finally:
        log, _ = counted.communicate()
    require(counted.returncode == 0,
            "nvcc failed for the counted K7 build:\n" + log)
    built["nw_backtrack_counted"] = {
        "seconds": time.perf_counter() - t0, "ptxas": log}
    total = time.perf_counter() - t0
    for name, info in built.items():
        for line in info["ptxas"].splitlines():
            if "Compiling entry function" in line:
                # the (mangled) kernel the following lines describe
                print("ptxas %s: %s" % (name, line.split("'")[1]))
            if "registers" in line or "spill" in line:
                print("ptxas %s: %s" % (name, line.strip()))
    emit({"phase": "build", "seconds": total,
          "per_kernel_seconds": {k: v["seconds"] for k, v in built.items()},
          "card": gpu})


def int_mm_yardstick(bits, chunks) -> list:
    """ms of the library yardstick for each (Kbits, counts, name) of
    ``chunks``: the same counts as one int8 library product of the one-hot
    query matrix and the unpacked bit matrix (never used by the port),
    checked equal to the kernel's counts.  The bit matrix is unpacked once
    for them all."""
    import torch
    V, words = bits.shape
    dev = bits.device
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    # the unpacked bits (V, positions) are stored column-major, the layout
    # the int8 library product takes for its second operand
    unpacked_t = torch.empty((words * 32, V), dtype=torch.int8, device=dev)
    for r0 in range(0, V, 2048):
        unpacked_t[:, r0:r0 + 2048] = ((bits[r0:r0 + 2048, :, None] >> shifts)
                                       & 1).reshape(-1, words * 32).t()
    unpacked = unpacked_t.t()
    library_ms = []
    for Kbits, counts, name in chunks:
        onehot = ((Kbits[:, :, None] >> shifts) & 1).reshape(
            Kbits.shape[0], -1)[:, :V].to(torch.int8).contiguous()
        lib = torch._int_mm(onehot, unpacked)
        torch.cuda.synchronize()
        require(torch.equal(lib, counts),
                "library product differs from " + name)
        library_ms.append(timed(lambda: torch._int_mm(onehot, unpacked), 5))
        del onehot, lib
    del unpacked, unpacked_t
    torch.cuda.empty_cache()
    return library_ms


def search_chunk(db_path, q_path):
    """The search cell's context and its first 512-query chunk as K1 takes
    it: (ctx, query sequences, their k-mer lists, Kbits on the card), to
    be scored against ctx.device_index.blocks[0]."""
    import numpy as np
    import torch
    from vsearch_tpu_torch import cli, device
    from vsearch_tpu_torch.core.search import SearchContext, load_db_and_index
    from vsearch_tpu_torch.io import fastx
    from vsearch_tpu_torch.ops import kmer, score_dense

    params = cli.parse_args(["--usearch_global", str(q_path), "--db",
                             str(db_path), "--uc", os.devnull] + FULL_ARGS)
    # fills load_db_and_index's session cache, which the full-width
    # CLI runs of phase 4 then reuse
    db, index = load_db_and_index(params, params.opt_db)
    ctx = SearchContext.build(params, db, index=index)
    recs = []
    for rec in fastx.read_fastx(str(q_path), params):
        recs.append(rec)
        if len(recs) == 512:
            break
    qseqs = [t.seqs[0] for t in ctx.prepare_tasks(recs)]
    klists = [kmer.unique_kmer_set(s, index.wordlength, params.opt_qmask)
              for s in qseqs]
    Kbits = torch.from_numpy(score_dense.pack_query_bits(
        klists, len(klists), ctx.device_index.hashsize).view(np.int32))
    return ctx, qseqs, klists, Kbits.to(device.select("cuda"))


def search_prefetch_args(ctx, qseqs, Kbits):
    """K2's inputs (qmT, amT, qlen, t4T, tlen) for the search prefetch of
    a chunk: each query with its top-1 candidate of the first index block;
    also returns the candidates' positions."""
    import torch
    from vsearch_tpu_torch.ops import nw_batch, score_dense
    di = ctx.device_index
    bits, words, _, n_real = di.blocks[0]
    dev = Kbits.device
    qp = len(qseqs)
    _, top = score_dense.dense_topk(di.hashsize, words, qp, 1)(
        Kbits, bits, n_real)
    M = nw_batch._bucket(max(len(s) for s in qseqs))
    N = di.db_codes_width
    qmT, amT = nw_batch.encode_rowT(qseqs, qp, M, ctx.scheme.mismatch,
                                    ctx.scheme.n_mismatch)
    qlen = torch.tensor([len(s) for s in qseqs], dtype=torch.int32,
                        device=dev)
    p = top[:, 0].to(torch.int64).clamp(0, di.n - 1)
    t4T = di.db_codes[p][:, :N].t().contiguous()
    tlen = torch.clamp(di.tlen_by_pos_dev[p], max=N).to(torch.int32)
    return (torch.from_numpy(qmT).to(dev), torch.from_numpy(amT).to(dev),
            qlen, t4T, tlen), p


def search_codes_args(ctx, qseqs, args, p):
    """K6's inputs (q4, qlen, t4, tlen) on the search prefetch's top-1
    pairs, from search_prefetch_args' K2 inputs and positions."""
    import torch
    from vsearch_tpu_torch.ops import nw_batch
    qlen, tlen = args[2], args[4]
    M, N = args[0].shape[0], args[3].shape[0]
    q4 = torch.from_numpy(nw_batch.encode_padded(qseqs, len(qseqs), M))
    return (q4.to(qlen.device), qlen,
            ctx.device_index.db_codes[p][:, :N].contiguous(), tlen)


def cluster_codes_args(g, qseqs, idx, qlen, M):
    """K6's inputs (q4, qlen, t4, tlen) on a cluster round's top-1 pairs,
    as the codes wire's prefetch (nw_batch.gather_align) builds them."""
    import torch
    from vsearch_tpu_torch.ops import nw_batch
    N = g.codes_width
    p1 = idx[:, 0].to(torch.int64).clamp(0, g.codes.shape[0] - 1)
    t4 = g.codes[p1][:, :N].contiguous()
    tlen = torch.clamp(g.tlen_dev[p1], max=N).to(torch.int32)
    q4 = torch.from_numpy(nw_batch.encode_padded(qseqs, len(qseqs), M))
    return q4.to(qlen.device), qlen, t4, tlen


def phase_kernels(gpu, db_path, q_path):
    """Each kernel against its plain version at the main path's shapes,
    with the main path's own inputs: the first 512-query chunk of the
    full-width run scored against its index, then aligned with its top-1
    candidates."""
    import torch
    from vsearch_tpu_torch import device
    from vsearch_tpu_torch.ops import cuda_lib, nw_batch, score_dense

    device.select("cuda")
    ctx, qseqs, klists, Kbits = search_chunk(db_path, q_path)
    di = ctx.device_index
    bits, words, _, n_real = di.blocks[0]
    V = di.hashsize
    qp = len(klists)
    out = []

    # K1: counts + packed key
    cuda_lib.reset_launches()
    got = score_dense.counts_or_keys(Kbits, bits, n_real, True)
    ref = score_dense.counts_or_keys_plain(Kbits, bits, n_real, True)
    torch.cuda.synchronize()
    err1 = max_abs_err(got, ref)
    require(err1 == 0, "K1 differs from its plain version")
    counts = score_dense.counts_or_keys(Kbits, bits, n_real, False)
    ms = timed(lambda: score_dense.counts_or_keys(Kbits, bits, n_real, True),
               20)
    plain_ms = timed(lambda: score_dense.counts_or_keys_plain(
        Kbits, bits, n_real, True), 1)
    # the yardstick also at one query's chunk, on the same unpacked bits
    Kbits1 = single_query_bits(klists[0], V, bits.device)
    library_ms, library_ms1 = int_mm_yardstick(bits, [
        (Kbits, counts, "K1"),
        (Kbits1, score_dense.counts_or_keys(Kbits1, bits, n_real, False),
         "K1 at one query")])
    nnz = int(sum(k.size for k in klists))
    k1_bytes = (Kbits.numel() + bits.numel() + got.numel()) * 4
    k1_ops = 2 * nnz * words * 32
    bound_ms, bound_by = bound(k1_bytes, k1_ops, INT8_TC_OPS)
    out.append({"kernel": "score_dense", "shape": {"qp": qp, "V": V,
                                                   "words": words,
                                                   "ids": nnz},
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "max_abs_err": err1,
                "launches": cuda_lib.LAUNCHES["score_dense"], "card": gpu})
    emit(out[-1])
    out.append(single_query_record(gpu, Kbits1, klists[0].size, bits,
                                   n_real, library_ms1))
    emit(out[-1])

    # K2 + K3: each query aligned with its top-1 candidate (the prefetch)
    args, p = search_prefetch_args(ctx, qseqs, Kbits)
    out.extend(nw_records(gpu, ctx.aligner._key, ctx.scheme, args, ""))
    # K2 + K3 at a walk round's shape: the smallest pair bucket of them
    walk_b = nw_batch.BatchAligner.PAIR_BUCKETS[0]
    out.extend(nw_records(gpu, ctx.aligner._key, ctx.scheme,
                          tuple(a[..., :walk_b].contiguous() for a in args),
                          "_walk"))
    # K6 + K7: the same pairs on the codes wire, under --mismatch -200, and
    # a walk round's first 128 of them
    codes = search_codes_args(ctx, qseqs, args, p)
    key200 = mismatch_200_key(ctx.aligner._key)
    k2_ms = next(o["ms"] for o in out if o["kernel"] == "nw_rowscan")
    out.extend(wavefront_records(gpu, key200, codes, "", k2_ms))
    k2_ms = next(o["ms"] for o in out if o["kernel"] == "nw_rowscan_walk")
    out.extend(wavefront_records(
        gpu, key200, tuple(a[:walk_b].contiguous() for a in codes), "_walk",
        k2_ms))
    return {o["kernel"]: o for o in out}


def single_query_bits(kmers, V: int, dev):
    """Kbits of one vstpu_search_single call: one query packed into a chunk
    of 128 rows, as DeviceKmerIndex._chunk_topk packs a chunk of at most
    128."""
    import numpy as np
    import torch
    from vsearch_tpu_torch.ops import score_dense
    return torch.from_numpy(score_dense.pack_query_bits(
        [kmers], 128, V).view(np.int32)).to(dev)


def single_query_record(gpu, Kbits, ids: int, bits, n_real: int,
                        library_ms: float) -> dict:
    """K1 at the shape of one vstpu_search_single call (single_query_bits,
    with ``ids`` k-mers) against its plain version, timed, with its bound
    and the library yardstick's ms at that chunk: the "single" shape of
    score_dense."""
    import torch
    from vsearch_tpu_torch.ops import cuda_lib, score_dense
    words = bits.shape[1]
    cuda_lib.reset_launches()
    got = score_dense.counts_or_keys(Kbits, bits, n_real, True)
    ref = score_dense.counts_or_keys_plain(Kbits, bits, n_real, True)
    torch.cuda.synchronize()
    err = max_abs_err(got, ref)
    require(err == 0, "K1 differs from its plain version at one query")
    launches = cuda_lib.LAUNCHES["score_dense"]
    ms = timed(lambda: score_dense.counts_or_keys(Kbits, bits, n_real, True),
               20)
    plain_ms = timed(lambda: score_dense.counts_or_keys_plain(
        Kbits, bits, n_real, True), 1)
    # data-dependent: the index rows of the query's k-mers, not the whole
    # index
    nbytes = (Kbits.numel() + ids * words + got.numel()) * 4
    bound_ms, bound_by = bound(nbytes, 2 * ids * words * 32, INT8_TC_OPS)
    return {"kernel": "score_dense_single",
            "shape": {"qp": Kbits.shape[0], "queries": 1,
                      "V": bits.shape[0], "words": words, "ids": int(ids)},
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": err, "launches": launches, "card": gpu}


def nw_records(gpu, key, scheme, args, tag: str):
    """K2 and K3 on one batch of forward inputs (qmT, amT, qlen, t4T,
    tlen): each against its plain version, timed, with its bound."""
    import torch
    from vsearch_tpu_torch.ops import cuda_lib, nw_batch, nw_rowscan
    qmT, _, qlen, t4T, tlen = args
    M, B = qmT.shape
    N = t4T.shape[0]
    key = tuple(int(v) for v in key)
    fwd = nw_rowscan.build_forward(key)
    cuda_lib.reset_launches()
    s_k, o_k, d_k = fwd(*args)
    track = nw_rowscan.overflow_possible(key, M, N)
    score_min = scheme.score_min()
    s_p, o_p, d_p = nw_rowscan.forward_plain(key, score_min, track, *args)
    torch.cuda.synchronize()
    err2 = max(max_abs_err(s_k, s_p), max_abs_err(o_k, o_p),
               max_abs_err(d_k, d_p))
    require(err2 == 0, "K2 differs from its plain version" + tag)
    del s_p, o_p, d_p
    ms = timed(lambda: fwd(*args), 3)
    plain_ms = timed(lambda: nw_rowscan.forward_plain(
        key, score_min, track, *args), 1)
    cells = M * N * B
    k2_bytes = (sum(a.numel() * a.element_size() for a in args)
                + s_k.numel() * 4 + o_k.numel() + d_k.numel() * 2)
    bound_ms, bound_by = bound(k2_bytes, cells * NW_CELL_OPS, int_ops(
        nw_rowscan.fits_int16(key, M, N)))
    out = [{"kernel": "nw_rowscan" + tag, "shape": {"B": B, "M": M, "N": N},
            "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "gcups": cells / (ms * 1e-3) / 1e9, "max_abs_err": err2,
            "launches": cuda_lib.LAUNCHES["nw_rowscan"], "card": gpu}]
    emit(out[-1])

    # K3: backtrack of those alignments, timed on one plane (its walked
    # cells stay in L2 from one launch to the next) and right after a
    # fresh K2 launch wrote the plane, as the pipeline runs it
    cuda_lib.reset_launches()
    ops_k = nw_batch.backtrack_rle(d_k, qlen, tlen)
    ops_p = nw_batch.backtrack_rle_plain(d_k, qlen, tlen)
    torch.cuda.synchronize()
    err3 = max_abs_err(ops_k, ops_p)
    require(err3 == 0, "K3 differs from its plain version" + tag)
    ms = timed(lambda: nw_batch.backtrack_rle(d_k, qlen, tlen), 10)
    launches = cuda_lib.LAUNCHES["nw_backtrack"]
    del d_k
    ms_after_k2 = timed_after(lambda: fwd(*args)[2],
                              lambda d: nw_batch.backtrack_rle(d, qlen, tlen),
                              5)
    d_k = fwd(*args)[2]
    plain_ms = timed(lambda: nw_batch.backtrack_rle_plain(d_k, qlen, tlen),
                     1)
    lane_steps = (ops_k != 0).sum(dim=0)
    steps = int(lane_steps.sum())
    reads = int(cells_read(ops_k.cpu().numpy(), qlen.cpu().numpy(),
                           tlen.cpu().numpy()).sum())
    # data-dependent: the dirs cells on the walked paths (drains read
    # none), lengths, ops out
    k3_bytes = reads * 2 + 2 * B * 4 + ops_k.numel() * 2
    bound_ms, bound_by = bound(k3_bytes, steps * 10,
                               int_ops(walk_fits16(M, N)))
    out.append({"kernel": "nw_backtrack" + tag,
                "shape": {"B": B, "M": M, "N": N, "steps": steps,
                          "reads": reads},
                "ms": ms, "ms_after_k2": ms_after_k2, "plain_ms": plain_ms,
                "library_ms": None, "bound_ms": bound_ms,
                "bound_by": bound_by, "max_abs_err": err3,
                "max_steps": int(lane_steps.max()),
                "mean_steps": steps / B,
                "launches": launches, "card": gpu})
    emit(out[-1])
    return out


def wavefront_records(gpu, key, args, tag: str, k2_ms: float):
    """K6 and K7 on one batch of codes-wire inputs (q4, qlen, t4, tlen)
    under a scheme whose mismatch score lies outside int8: each against its
    plain version, timed, with its bound.  k2_ms, K2's time on the same
    pairs under the default scheme, rides along as a note."""
    import torch
    from vsearch_tpu_torch.ops import cuda_lib, nw_batch, nw_rowscan
    from vsearch_tpu_torch.ops import nw_wavefront
    from vsearch_tpu_torch.ops.nw import ScoreScheme
    q4, qlen, t4, tlen = args
    B, M = q4.shape
    N = t4.shape[1]
    score_min = ScoreScheme(*key[:14], bool(key[14])).score_min()
    fwd = nw_wavefront.build_forward(key)
    cuda_lib.reset_launches()
    s_k, o_k, d_k = fwd(*args)
    s_p, o_p, d_p = nw_wavefront.forward_plain(key, score_min, *args)
    torch.cuda.synchronize()
    err6 = max(max_abs_err(s_k, s_p), max_abs_err(o_k, o_p),
               max_abs_err(d_k, d_p))
    require(err6 == 0, "K6 differs from its plain version" + tag)
    launches = cuda_lib.LAUNCHES["nw_wavefront"]
    del s_p, o_p, d_p
    ms = timed(lambda: fwd(*args), 5)
    plain_ms = timed(lambda: nw_wavefront.forward_plain(
        key, score_min, *args), 1)
    cells = M * N * B
    # data-dependent: the DP cells of the pairs' own lengths; the whole
    # plane is written
    valid = int((qlen.clamp(0, M).to(torch.int64)
                 * tlen.clamp(0, N).to(torch.int64)).sum())
    nbytes = (sum(a.numel() * a.element_size() for a in args)
              + s_k.numel() * 4 + o_k.numel() + d_k.numel())
    bound_ms, bound_by = bound(nbytes, valid * NW_CELL_OPS, int_ops(
        nw_rowscan.fits_int16(key, M, N)))
    out = [{"kernel": "nw_wavefront" + tag,
            "shape": {"B": B, "M": M, "N": N, "D": d_k.shape[0],
                      "Ms": d_k.shape[2], "cells": valid},
            "mismatch": key[1], "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "gcups": cells / (ms * 1e-3) / 1e9,
            "nw_rowscan_same_pairs_ms": k2_ms,
            "overflow_pairs": int(o_k.sum()), "max_abs_err": err6,
            "launches": launches, "card": gpu}]
    emit(out[-1])

    # K7: the flat backtrack of those alignments, timed on one plane and
    # right after a fresh K6 launch wrote it, as the pipeline runs it
    cuda_lib.reset_launches()
    ops_k = nw_batch.backtrack_flat(d_k, qlen, tlen)
    ops_p = nw_batch.backtrack_flat_plain(d_k, qlen, tlen)
    torch.cuda.synchronize()
    err7 = max_abs_err(ops_k, ops_p)
    require(err7 == 0, "K7 differs from its plain version" + tag)
    launches = cuda_lib.LAUNCHES["nw_backtrack_flat"]
    ms = timed(lambda: nw_batch.backtrack_flat(d_k, qlen, tlen), 10)
    ms_after_k6 = timed_after(
        lambda: fwd(*args)[2],
        lambda d: nw_batch.backtrack_flat(d, qlen, tlen), 5)
    plain_ms = timed(lambda: nw_batch.backtrack_flat_plain(d_k, qlen, tlen),
                     1)
    lane_steps = (ops_k != 0).sum(dim=0)
    steps = int(lane_steps.sum())
    windows = flat_windows(d_k, qlen, tlen, ops_p)
    reads = flat_cells_read(ops_p, qlen, tlen)
    # data-dependent: one dirs byte a cell on the walked paths (drains
    # read none), lengths, ops out
    nbytes = reads + 2 * B * 4 + ops_k.numel() * 2
    bound_ms, bound_by = bound(nbytes, steps * 10,
                               int_ops(walk_fits16(M, N)))
    out.append({"kernel": "nw_backtrack_flat" + tag,
                "shape": {"B": B, "M": M, "N": N, "steps": steps,
                          "reads": reads},
                "ms": ms, "ms_after_k6": ms_after_k6, "plain_ms": plain_ms,
                "library_ms": None,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "max_abs_err": err7, "max_steps": int(lane_steps.max()),
                "mean_steps": steps / B,
                "windows_max": int(windows.max()),
                "windows_mean": float(windows.mean()),
                "launches": launches, "card": gpu})
    emit(out[-1])
    del d_k
    torch.cuda.empty_cache()
    return out


def cluster_round(amp_path):
    """The clustering cell's growing index and one device round as K4
    takes it: the first member of every amp100k family indexed (the
    centroids a run ends with, heap ranks a random permutation, device
    codes attached) at the capacity the run sizes, 102 400 positions, and
    a 512-query round of other members.  Returns (params, index, query
    sequences, their k-mer lists, Kbits on the card)."""
    import numpy as np
    import torch
    from vsearch_tpu_torch import cli, device
    from vsearch_tpu_torch.core.cluster import ClusterEngine
    from vsearch_tpu_torch.ops import kmer, nw_batch, score_dense, score_grow

    dev = device.select("cuda")
    params = cli.parse_args(["--cluster_size", str(amp_path)] + CLUSTER_ARGS)
    w = params.opt_wordlength
    seqs = read_fasta(amp_path)
    rng = np.random.default_rng(AMP_SEED)
    cent = seqs[0::4]
    n = len(cent)
    seqno = rng.permutation(n)
    seq_of = dict(zip(seqno.tolist(), cent)).__getitem__
    # as ClusterEngine._device_capacity sizes it at activation
    cap = max(2 * ClusterEngine.DEVICE_MIN, 40960, len(seqs))
    g = score_grow.GrowingDeviceKmerIndex.build(
        w, [kmer.unique_kmer_set(s, w, params.opt_qmask) for s in cent],
        [len(s) for s in cent], seqno.tolist(), capacity=cap, device=dev)
    g.attach_codes(nw_batch._bucket(max(len(s) for s in cent)), seq_of)
    qp = ClusterEngine.DEVICE_ROUND
    pick = rng.choice(n, size=qp) * 4 + rng.integers(1, 4, size=qp)
    qseqs = [seqs[i] for i in pick.tolist()]
    klists = [kmer.unique_kmer_set(s, w, params.opt_qmask) for s in qseqs]
    Kbits = torch.from_numpy(score_dense.pack_query_bits(
        klists, qp, g.hashsize).view(np.int32)).to(dev)
    return params, g, qseqs, klists, Kbits


def cluster_prefetch_args(params, g, qseqs, klists, Kbits):
    """K2's inputs (qmT, amT, qlen, t4T, tlen) for the cluster prefetch of
    a round, as compact_gather builds them: the round's top-8 candidates
    that pass minmatches packed into the prefetch's lanes, queries gathered
    by lane and targets by index position.  Also returns the live-lane
    mask, the top-k positions (qp, 8) and the round's own (qmT, amT, qlen)
    on the card."""
    import torch
    from vsearch_tpu_torch.core.cluster import ClusterEngine
    from vsearch_tpu_torch.ops import nw_batch, score_dense
    from vsearch_tpu_torch.ops.nw import ScoreScheme

    dev = Kbits.device
    qp = len(klists)
    K = ClusterEngine.PREFETCH_K
    R = ClusterEngine.PREFETCH_LANES
    vals, idx = score_dense.dense_topk_ranked(g.hashsize, g.words, qp, K)(
        Kbits, g.bits[:g.hashsize], g._ranks())
    mm = torch.tensor([min(params.opt_minwordmatches, k.size)
                       for k in klists], dtype=torch.int32, device=dev)
    lanes = nw_batch.compact_lanes(vals, idx, mm, K, R, g.n)
    live = lanes < qp * K
    lane_c = torch.where(live, lanes, 0).long()
    q_idx = lane_c % qp
    pos = idx.reshape(-1)[q_idx * K + lane_c // qp].long()
    pos = torch.where(live, pos, 0)
    M = nw_batch._bucket(max(len(s) for s in qseqs))
    N = g.codes_width
    scheme = ScoreScheme.from_params(params)
    qmT, amT = nw_batch.encode_rowT(qseqs, qp, M, scheme.mismatch,
                                    scheme.n_mismatch)
    qlen = torch.tensor([len(s) for s in qseqs], dtype=torch.int32,
                        device=dev)
    queries = (torch.from_numpy(qmT).to(dev), torch.from_numpy(amT).to(dev),
               qlen)
    args = (queries[0][:, q_idx].contiguous(),
            queries[1][:, q_idx].contiguous(),
            torch.where(live, qlen[q_idx], 1),
            g.codes[pos][:, :N].t().contiguous(),
            torch.clamp(g.tlen_dev[pos], max=N).to(torch.int32))
    return args, live, idx, queries


def ranked_record(gpu, name: str, Kbits, bits, rank, nnz: int,
                  shape: dict) -> dict:
    """K4 on one chunk's inputs (query bits Kbits, the index's bits, maybe
    a column prefix at the index's row stride, and the position ranks)
    against its plain version, every occupied position keyed, timed beside
    the plain version and the library product, with its bound from the
    chunk's nnz query k-mers."""
    import torch
    from vsearch_tpu_torch.ops import cuda_lib, score_dense
    qp = Kbits.shape[0]
    V, words = bits.shape
    occupied = int((rank < score_dense.RANK_MAX).sum())
    cuda_lib.reset_launches()
    got = score_dense.ranked_keys(Kbits, bits, rank)
    ref = score_dense.ranked_keys_plain(Kbits, bits, rank)
    torch.cuda.synchronize()
    err = max_abs_err(got, ref)
    require(err == 0, "K4 differs from its plain version (%s)" % name)
    require(int((got >= 0).sum()) == qp * occupied,
            "K4 keys of empty positions (%s)" % name)
    del ref
    launches = cuda_lib.LAUNCHES["score_ranked"]
    ms = timed(lambda: score_dense.ranked_keys(Kbits, bits, rank), 20)
    plain_ms = timed(lambda: score_dense.ranked_keys_plain(
        Kbits, bits, rank), 1)
    counts = score_dense.counts_or_keys(Kbits, bits, 0, False)
    library_ms, = int_mm_yardstick(bits, [(Kbits, counts,
                                           "K4 (%s)" % name)])
    del counts
    k4_bytes = (Kbits.numel() + bits.numel() + rank.numel()
                + got.numel()) * 4
    bound_ms, bound_by = bound(k4_bytes, 2 * nnz * words * 32, INT8_TC_OPS)
    rec = {"kernel": name,
           "shape": dict({"qp": qp, "V": V, "words": words,
                          "occupied": occupied, "ids": nnz}, **shape),
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
           "launches": launches, "card": gpu}
    emit(rec)
    del got
    torch.cuda.empty_cache()
    return rec


def phase_cluster_kernels(gpu, amp_path):
    """K4 at the full clustering width and on the filled prefix, then K2
    and K3 at the cluster prefetch's shape, on inputs from the amp100k
    cell: a growing index of the first member of every family (the
    centroids a run ends with, heap ranks a random permutation) at the
    capacity the run sizes, 102 400 positions, scored by a 512-query round
    of other members, whose compacted top-8 candidates then fill the
    prefetch's 2048 lanes."""
    import torch
    from vsearch_tpu_torch import device
    from vsearch_tpu_torch.core.cluster import ClusterEngine
    from vsearch_tpu_torch.ops import nw_batch, nw_rowscan
    from vsearch_tpu_torch.ops.nw import ScoreScheme

    dev = device.select("cuda")
    params, g, qseqs, klists, Kbits = cluster_round(amp_path)
    bits = g.bits[:g.hashsize]
    rank = g._ranks()
    out = {}

    nnz = int(sum(k.size for k in klists))
    out["score_ranked"] = ranked_record(gpu, "score_ranked", Kbits, bits,
                                        rank, nnz, {})
    # K4 as the cell's top-k runs it at this occupancy: on the filled
    # prefix of whole 4096-position blocks (GrowingDeviceKmerIndex
    # .topk_dispatch), a column prefix of the same matrix
    used = g.scan_words()
    out["score_ranked_prefix"] = ranked_record(
        gpu, "score_ranked_prefix", Kbits, bits[:, :used],
        rank[:used * 32], nnz, {"row_stride": g.words})

    # the prefetch's forward inputs: compact_gather's lanes and gathers
    R = ClusterEngine.PREFETCH_LANES
    args, live, idx, (qmT, amT, qlen) = cluster_prefetch_args(
        params, g, qseqs, klists, Kbits)
    scheme = ScoreScheme.from_params(params)
    key = nw_batch.BatchAligner(scheme, dev)._key
    emit({"phase": "cluster_prefetch_lanes", "lanes": R,
          "live": int(live.sum()), "card": gpu})
    for rec in nw_records(gpu, key, scheme, args, "_cluster"):
        out[rec["kernel"]] = rec
    del args
    torch.cuda.empty_cache()

    # K6 + K7 on the round's top-1 pairs (the codes wire's prefetch,
    # nw_batch.gather_align), beside K2 on the same pairs under the
    # default scheme
    codes = cluster_codes_args(g, qseqs, idx, qlen, qmT.shape[0])
    k2 = nw_rowscan.build_forward(key)
    k2_args = (qmT, amT, qlen, codes[2].t().contiguous(), codes[3])
    k2_ms = timed(lambda: k2(*k2_args), 3)
    del k2_args
    for rec in wavefront_records(gpu, mismatch_200_key(key), codes,
                                 "_cluster", k2_ms):
        out[rec["kernel"]] = rec
    return out


def allpairs_first_batch(ap_path):
    """(AllPairsDevice, scheme, K2m's inputs) of the allpairs cell's first
    batch (W=400, B=4096: the triangle's first PAIR_BATCH pairs, gathered
    as AllPairsDevice.run gathers them)."""
    import numpy as np
    import torch
    from vsearch_tpu_torch import cli, device
    from vsearch_tpu_torch.ops import allpairs_dev
    from vsearch_tpu_torch.ops.nw import ScoreScheme

    dev = device.select("cuda")
    params = cli.parse_args(["--allpairs_global", str(ap_path)] + AP_ARGS)
    scheme = ScoreScheme.from_params(params)
    ap = allpairs_dev.AllPairsDevice(scheme, read_fasta(ap_path)[:AP_SEQS],
                                     dev)
    qpos, tpos = np.triu_indices(AP_SEQS, 1)
    B = ap.batch
    args = ap.batch_wire(torch.from_numpy(qpos[:B]).to(dev),
                         torch.from_numpy(tpos[:B]).to(dev))
    return ap, scheme, args


def k5_span() -> int:
    """K5_SPAN of the shipped csrc/nw_stats.cu."""
    import re
    from vsearch_tpu_torch.ops import cuda_lib
    text = (cuda_lib.CSRC / "nw_stats.cu").read_text()
    return int(re.search(r"#define K5_SPAN (\d+)", text).group(1))


def cells_read(ops, qlen, tlen):
    """Entries a lane that read a cell of the plane (numpy, from K3's ops
    wire): every entry but the boundary drains, those taken with i < 0 or
    j < 0."""
    import numpy as np
    v = ops.astype(np.int64) & 0xFFFF
    op, cnt = v & 3, v >> 2
    di = np.where((op == 1) | (op == 2), cnt, 0)
    dj = np.where((op == 1) | (op == 3), cnt, 0)
    # i and j before each entry
    i = qlen.astype(np.int64) - 1 - (np.cumsum(di, axis=0) - di)
    j = tlen.astype(np.int64) - 1 - (np.cumsum(dj, axis=0) - dj)
    return ((v != 0) & (i >= 0) & (j >= 0)).sum(axis=0)


def window_rounds(ops, qlen, tlen, span: int):
    """Windows a lane fetches walking its ops (numpy, from K3's ops wire)
    through triangle windows of a span, modelled on the host by the rule
    K3 and K5 walk by: a fetch wherever the cell read lies outside the
    last window, (ai - i) + (aj - j) >= span."""
    import numpy as np
    i = qlen.astype(np.int64) - 1
    j = tlen.astype(np.int64) - 1
    far = np.int64(1 << 40)
    ai = np.full_like(i, far)
    aj = np.full_like(j, far)
    rounds = np.zeros_like(i)
    for row in ops:
        v = row.astype(np.int64) & 0xFFFF
        op, cnt = v & 3, v >> 2
        read = (v != 0) & (i >= 0) & (j >= 0)
        need = read & ((ai - i) + (aj - j) >= span)
        rounds += need
        ai = np.where(need, i, ai)
        aj = np.where(need, j, aj)
        i = i - np.where((op == 1) | (op == 2), cnt, 0)
        j = j - np.where((op == 1) | (op == 3), cnt, 0)
    return rounds


def flat_cells_read(ops, qlen, tlen) -> int:
    """Cells of the plane K7's walks read, from its flat ops wire: one a
    move before a drain (cells_read, a plain code read as a count of 1)."""
    import numpy as np
    v = ops.cpu().numpy()
    return int(cells_read(np.where(v != 0, v | 4, 0), qlen.cpu().numpy(),
                          tlen.cpu().numpy()).sum())


def flat_windows(dirs, qlen, tlen, ref):
    """The windows each pair's K7 walk fetches on these inputs, as the
    card counts them: the counted build (phase_build) launched once, its
    ops checked equal to ref, the plain version's."""
    import ctypes
    import numpy as np
    import torch
    from vsearch_tpu_torch.ops import cuda_lib
    D, B, Ms = dirs.shape
    require(B <= COUNTED_PAIRS, "more pairs than the counted K7 build holds")
    lib = ctypes.CDLL(str(counted_so()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nw_backtrack_flat_launch.argtypes = [p, p, p, i, i, i, p, p]
    lib.nw_backtrack_flat_windows.argtypes = [p, i]
    ops = torch.full((D + 1, B), 0x5555, dtype=torch.int16,
                     device=dirs.device)
    require(lib.nw_backtrack_flat_launch(
        dirs.data_ptr(), qlen.data_ptr(), tlen.data_ptr(), D, B, Ms,
        ops.data_ptr(), cuda_lib.stream_ptr(dirs.device)) == 0,
        "counted K7 launch")
    torch.cuda.synchronize()
    require(torch.equal(ops, ref), "counted K7 differs from the plain version")
    windows = np.zeros(B, dtype=np.int32)
    require(lib.nw_backtrack_flat_windows(windows.ctypes.data, B) == 0,
            "nw_backtrack_flat_windows")
    return windows


def phase_allpairs_kernels(gpu, ap_path):
    """K2m and K5 on the allpairs cell's first batch (allpairs_first_batch),
    each against its plain version; K5 reads K2m's planes.  K2m as routed
    (its 16-bit body) and its 32-bit body on the same inputs, each
    held against the plain version and timed in turns (16, 32, 32, 16),
    and against each other on three later batches.  No single PyTorch call
    computes either function."""
    import numpy as np
    import torch
    from vsearch_tpu_torch import device
    from vsearch_tpu_torch.ops import allpairs_dev, cuda_lib, nw_batch
    from vsearch_tpu_torch.ops import nw_rowscan

    dev = device.select("cuda")
    ap, scheme, args = allpairs_first_batch(ap_path)
    qpos, tpos = np.triu_indices(AP_SEQS, 1)
    B = ap.batch
    _, _, _, qlen, _, tlen = args
    W = ap.W
    key = tuple(int(v) for v in nw_batch.BatchAligner(scheme, dev)._key)
    track = nw_rowscan.overflow_possible(key, W, W)
    score_min = scheme.score_min()
    fwd = ap.forward
    planes = (torch.empty((W, W, B), dtype=torch.uint16, device=dev),
              torch.empty((W, W, B), dtype=torch.uint8, device=dev))
    out = {}

    require(nw_rowscan.rowscan16(key, W, W),
            "the allpairs cell is outside K2m's 16-bit envelope")

    def body(name):
        """K2m through one body on the batch's inputs (a private argument
        of the wrapper: the route would pick the 16-bit body)."""
        return lambda a=args, o=planes: nw_rowscan._forward(
            key, a[0], a[1], a[3], a[4], a[5], a[2], o, _body=name)

    cuda_lib.reset_launches()
    got = fwd(*args, out=planes)
    launches = dict(cuda_lib.LAUNCHES)
    require(launches["nw_rowscan_mr16"] == 1
            and launches["nw_rowscan_mr"] == 0,
            "K2m took its 32-bit body on the allpairs batch")
    ref = nw_rowscan.forward_plain(key, score_min, track, args[0], args[1],
                                   qlen, args[4], tlen, args[2])
    torch.cuda.synchronize()
    err = max(max_abs_err(g, r) for g, r in zip(got, ref))
    require(err == 0, "K2m (16-bit body) differs from its plain version")
    # the 32-bit body on the same inputs, into planes of its own
    old_planes = tuple(torch.empty_like(p) for p in planes)
    cuda_lib.reset_launches()
    old = body("nw_rowscan_mr")(o=old_planes)
    torch.cuda.synchronize()
    require(cuda_lib.LAUNCHES["nw_rowscan_mr"] == 1,
            "the private argument did not take the 32-bit body")
    err_old = max(max_abs_err(g, r) for g, r in zip(old, ref))
    require(err_old == 0, "K2m (32-bit body) differs from its plain "
            "version")
    del ref, old, old_planes
    torch.cuda.empty_cache()
    # the two bodies in turns on the same inputs: 16, 32, 32, 16
    turns = {name: [] for name in K2M_BODIES}
    for name in K2M_BODIES + K2M_BODIES[::-1]:
        turns[name].append(timed(body(name), 3))
    plain_ms = timed(lambda: nw_rowscan.forward_plain(
        key, score_min, track, args[0], args[1], qlen, args[4], tlen,
        args[2]), 1)
    # K2 on the same inputs, for what the match plane costs at this shape,
    # and K2m on three later batches of the triangle, one launch each,
    # both bodies equal there
    k2 = nw_rowscan.build_forward(key)
    k2_args = (args[0], args[1], qlen, args[4], tlen)
    k2_ms = timed(lambda: k2(*k2_args), 3)
    # (into planes of their own: K5 below reads the first batch's)
    later = [ap.batch_wire(torch.from_numpy(qpos[k * B:(k + 1) * B]).to(dev),
                           torch.from_numpy(tpos[k * B:(k + 1) * B]).to(dev))
             for k in (100, 200, 300)]
    later_planes = tuple(torch.empty_like(p) for p in planes)
    err_later = 0
    for a in later:
        new_out = [t.clone() for t in body("nw_rowscan_mr16")(a, later_planes)]
        old_out = body("nw_rowscan_mr")(a, later_planes)
        err_later = max([err_later] + [max_abs_err(g, r)
                                       for g, r in zip(new_out, old_out)])
        del new_out, old_out
    require(err_later == 0, "K2m's bodies differ on a later batch")

    def run_later(name):
        for a in later:
            body(name)(a, later_planes)
    later_ms = {name: timed(lambda: run_later(name), 1) / len(later)
                for name in K2M_BODIES}
    del later_planes
    torch.cuda.empty_cache()
    cells = W * W * B
    nbytes = (sum(a.numel() * a.element_size() for a in args)
              + B * 4 + B + cells * 3)
    # the function's bound, the same for both bodies: its values fit 16
    # bits, two a lane
    bound_ms, bound_by = bound(nbytes, cells * NW_MR_CELL_OPS, int_ops(
        nw_rowscan.fits_int16(key, W, W)))
    for name, errs in (("nw_rowscan_mr16", err), ("nw_rowscan_mr", err_old)):
        ms = sum(turns[name]) / len(turns[name])
        out[name] = {
            "kernel": name, "shape": {"B": B, "M": W, "N": W},
            "ms": ms, "ms_turns": turns[name], "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "int_ops_per_s": int_ops(False),
            "gcups": cells / (ms * 1e-3) / 1e9, "max_abs_err": errs,
            "max_abs_err_bodies_later": err_later,
            "mr_max": int(got[3].max()), "nw_rowscan_same_inputs_ms": k2_ms,
            "later_batches_ms": later_ms[name],
            "launches": launches[name], "card": gpu}
        emit(out[name])

    # K5 on those planes; K3 walks the same path, so its nonzero ops
    # count the walk's entries (and its windows at K5's span)
    dirs, mr = got[2], got[3]
    cuda_lib.reset_launches()
    st = allpairs_dev.stats_walk(dirs, mr, qlen, tlen)
    st_ref = allpairs_dev.stats_walk_plain(dirs, mr, qlen, tlen)
    ops = nw_batch.backtrack_rle_plain(dirs, qlen, tlen)
    lane_steps = (ops != 0).sum(dim=0)
    steps = int(lane_steps.sum())
    torch.cuda.synchronize()
    err = max_abs_err(st, st_ref)
    require(err == 0, "K5 differs from its plain version")
    launches = cuda_lib.LAUNCHES["nw_stats"]
    span = k5_span()
    ops_np, ql, tl = (t.cpu().numpy() for t in (ops, qlen, tlen))
    windows = window_rounds(ops_np, ql, tl, span)
    reads = int(cells_read(ops_np, ql, tl).sum())
    diagonal = int(((ops_np & 3) == 1).sum())
    del ops, ops_np
    ms = timed(lambda: allpairs_dev.stats_walk(dirs, mr, qlen, tlen), 10)
    # right after a fresh K2m launch wrote the planes, as the pipeline
    # runs it
    ms_after_k2m = timed_after(
        lambda: fwd(*args, out=planes),
        lambda g: allpairs_dev.stats_walk(g[2], g[3], qlen, tlen), 5)
    plain_ms = timed(lambda: allpairs_dev.stats_walk_plain(
        dirs, mr, qlen, tlen), 1)
    # data-dependent: the dirs cells on the walked paths (drains read
    # none), the mr cells of their diagonal entries, lengths, stats out
    nbytes = reads * 2 + diagonal + 2 * B * 4 + st.numel() * 4
    bound_ms, bound_by = bound(nbytes, steps * 15,
                               int_ops(walk_fits16(W, W)))
    cols = st.to(torch.float64).mean(dim=0).tolist()
    out["nw_stats"] = {
        "kernel": "nw_stats", "shape": {"B": B, "M": W, "N": W,
                                        "steps": steps, "reads": reads,
                                        "diagonal": diagonal},
        "ms": ms, "ms_after_k2m": ms_after_k2m, "plain_ms": plain_ms,
        "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
        "max_abs_err": err, "max_steps": int(lane_steps.max()),
        "mean_steps": steps / B, "span": span,
        "model_windows_max": int(windows.max()),
        "model_windows_mean": float(windows.mean()),
        "mean_stats": dict(zip(allpairs_dev.STATS_COLUMNS, cols)),
        "launches": launches, "card": gpu}
    emit(out["nw_stats"])
    del got, planes, dirs, mr
    torch.cuda.empty_cache()
    return out


class allpairs_counts:
    """Counts, in the allpairs command's fast path, the pairs it sends
    through the device pipeline and the batches it cuts them into
    (AllPairsDevice.batch), the overflow pairs, the pairs the stats accept
    and the pairs it aligns again through SearchContext.align_pairs
    (overflow and accepted): the program's own counters
    (utils/phasetimer ``tally``), turned on for the block."""

    NAMES = {"pairs": "allpairs.pairs", "batches": "allpairs.batches",
             "overflow": "allpairs.overflow",
             "accepted": "allpairs.accepted",
             "realigned": "allpairs.realigned"}

    def __enter__(self):
        from vsearch_tpu_torch.utils import phasetimer
        self._enabled = phasetimer.ENABLED
        self._before = dict(phasetimer.tally)
        phasetimer.ENABLED = True
        return self

    def __exit__(self, *exc):
        from vsearch_tpu_torch.utils import phasetimer
        phasetimer.ENABLED = self._enabled
        for attr, name in self.NAMES.items():
            setattr(self, attr, phasetimer.tally.get(name, 0)
                    - self._before.get(name, 0))

    def record(self) -> dict:
        return {"pairs": self.pairs, "batches": self.batches,
                "overflow_pairs": self.overflow,
                "accepted_by_stats": self.accepted,
                "realigned_pairs": self.realigned}


class walk_round_k2:
    """Counts the K2 launches (count) and the K6 launches (count_k6) of the
    walk rounds (BatchAligner._dispatch), so a run's prefetch launches are
    the rest."""

    def __enter__(self):
        from vsearch_tpu_torch.ops import cuda_lib, nw_batch
        self.count = self.count_k6 = 0
        aligner = nw_batch.BatchAligner
        self._orig = dispatch = aligner._dispatch

        def counted(this, qseqs, tseqs):
            before = cuda_lib.LAUNCHES["nw_rowscan"]
            before_k6 = cuda_lib.LAUNCHES["nw_wavefront"]
            handle = dispatch(this, qseqs, tseqs)
            self.count += cuda_lib.LAUNCHES["nw_rowscan"] - before
            self.count_k6 += cuda_lib.LAUNCHES["nw_wavefront"] - before_k6
            return handle

        aligner._dispatch = counted
        return self

    def __exit__(self, *exc):
        from vsearch_tpu_torch.ops import nw_batch
        nw_batch.BatchAligner._dispatch = self._orig


class largest_wave:
    """Keeps the forward inputs of the largest alignment wave (B x M x N)
    that BatchAligner._dispatch sends to the card (args, None if none
    did), and the pairs of the largest alignment call by DP cells on
    whichever tier the router sent it (call, None if none was made)."""

    def __enter__(self):
        from vsearch_tpu_torch.ops import nw_batch
        self.args = self.call = None
        self._cells = 0
        aligner = nw_batch.BatchAligner
        self._orig = dispatch = aligner._dispatch
        self._orig_align = align = aligner.align_pairs

        def spied(this, qseqs, tseqs):
            fwd = this._forward

            def keep(*args):
                size = args[0].numel() * args[3].shape[0]
                if self.args is None or size > self._size:
                    self.args, self._size = args, size
                return fwd(*args)

            this._forward = keep
            try:
                return dispatch(this, qseqs, tseqs)
            finally:
                this._forward = fwd

        def seen(this, qseqs, tseqs):
            cells = sum(len(q) * len(t) for q, t in zip(qseqs, tseqs))
            if cells > self._cells:
                self.call, self._cells = (list(qseqs), list(tseqs)), cells
            return align(this, qseqs, tseqs)

        aligner._dispatch = spied
        aligner.align_pairs = seen
        return self

    def __exit__(self, *exc):
        from vsearch_tpu_torch.ops import nw_batch
        nw_batch.BatchAligner._dispatch = self._orig
        nw_batch.BatchAligner.align_pairs = self._orig_align


class ranked_words:
    """Counts K4's launches (launches) and the packed words they scan
    (words), read at score_dense.ranked_keys.  With keep, also keeps a copy
    of the inputs (Kbits, bits, rank) of the largest launch by query rows
    x words scanned (largest), bits a column prefix at the index's row
    stride as the launch read it."""

    def __init__(self, keep: bool = False):
        self.keep = keep

    def __enter__(self):
        import torch
        from vsearch_tpu_torch.ops import score_dense
        self.launches = self.words = 0
        self.largest, self._size = None, 0
        self._orig = ranked_keys = score_dense.ranked_keys

        def counted(Kbits, bits, rank):
            if bits.is_cuda:
                self.launches += 1
                self.words += bits.shape[1]
                size = Kbits.shape[0] * bits.shape[1]
                if self.keep and size > self._size:
                    self.largest = None
                    wide = torch.empty((bits.shape[0], bits.stride(0)),
                                       dtype=bits.dtype, device=bits.device)
                    prefix = wide[:, :bits.shape[1]]
                    prefix.copy_(bits)
                    self.largest = (Kbits.clone(), prefix, rank.clone())
                    self._size = size
            return ranked_keys(Kbits, bits, rank)

        score_dense.ranked_keys = counted
        return self

    def __exit__(self, *exc):
        from vsearch_tpu_torch.ops import score_dense
        score_dense.ranked_keys = self._orig


def phase_parity(gpu):
    """Two small workloads (the random one of write_parity_workload and the
    families of write_family_workload), four option sets each, three runs
    each: on cuda as the aligner routes it (walk rounds this small go to
    the host C tier), on cuda with every walk round forced onto the device
    aligner (BatchAligner.align_pairs -> K2 + K3 at the pair-bucket
    shapes, K6 + K7 under --mismatch -200), and on cpu (the plain
    versions).  All three must be byte-equal.  The forward launches of
    each cuda run are split into those of the walk rounds
    (BatchAligner._dispatch) and those of the top-1 prefetch; the
    families' forced runs must have walk-round launches on either wire.
    The --mismatch -200 runs must launch K6 and K7 and no K2, K3 or plain
    version, the others no K6 or K7."""
    from vsearch_tpu_torch import cli
    from vsearch_tpu_torch.ops import cuda_lib, nw_batch
    d = WORK / "parity"
    d.mkdir(parents=True, exist_ok=True)
    workloads = {"random": write_parity_workload(d),
                 "families": write_family_workload(d)}
    option_sets = {
        "ma1": ["--id", "0.8", "--maxaccepts", "1", "--maxrejects", "32"],
        "ma4_nohits": ["--id", "0.9", "--maxaccepts", "4", "--maxrejects",
                       "8", "--output_no_hits"],
        "both": ["--id", "0.8", "--strand", "both"],
        "mm200": ["--id", "0.8", "--maxaccepts", "4", "--maxrejects", "8"]
                 + MISMATCH_200}
    aligner = nw_batch.BatchAligner
    crossover = aligner._native_cells_crossover
    try:
        for wname, (db, q) in workloads.items():
            forced_walk_k2 = forced_walk_k6 = 0
            for name, extra in option_sets.items():
                codes = "--mismatch" in extra
                outs = {}
                for run in ("cuda", "cuda_forced", "cpu"):
                    aligner._native_cells_crossover = (
                        (lambda self: 0) if run == "cuda_forced"
                        else crossover)
                    uc = d / ("%s.%s.%s.uc" % (wname, name, run))
                    b6 = d / ("%s.%s.%s.b6" % (wname, name, run))
                    cuda_lib.reset_launches()
                    with walk_round_k2() as walk:
                        rc = cli.main(["--usearch_global", str(q), "--db",
                                       str(db), "--uc", str(uc),
                                       "--blast6out", str(b6), "--threads",
                                       "1", "--quiet"] + extra,
                                      device="cpu" if run == "cpu"
                                      else "cuda")
                    require(rc == 0, "usearch_global failed (%s)" % run)
                    outs[run] = (uc.read_bytes(), b6.read_bytes())
                    if run == "cpu":
                        continue
                    launches = dict(cuda_lib.LAUNCHES)
                    require_wire(launches, codes, "%s, %s, %s"
                                 % (wname, name, run))
                    if codes:
                        require(not any(cuda_lib.PLAIN_CALLS.values()),
                                "a plain version ran on the card (%s, %s)"
                                % (wname, name))
                    if run == "cuda_forced":
                        forced_walk_k2 += walk.count
                        forced_walk_k6 += walk.count_k6
                    emit({"phase": "parity_launches", "workload": wname,
                          "options": name, "run": run, "launches": launches,
                          "nw_rowscan_walk_rounds": walk.count,
                          "nw_rowscan_prefetch":
                              launches["nw_rowscan"] - walk.count,
                          "nw_wavefront_walk_rounds": walk.count_k6,
                          "nw_wavefront_prefetch":
                              launches["nw_wavefront"] - walk.count_k6,
                          "card": gpu})
                require(outs["cuda"] == outs["cpu"],
                        "cuda and cpu outputs differ (%s, %s)"
                        % (wname, name))
                require(outs["cuda_forced"] == outs["cpu"],
                        "cuda with device walk rounds and cpu outputs "
                        "differ (%s, %s)" % (wname, name))
                require(outs["cuda"][0].count(b"\n") == 64,
                        "uc of %s, %s does not have 64 lines"
                        % (wname, name))
                emit({"phase": "parity", "workload": wname, "options": name,
                      "equal": True, "uc_lines": 64, "card": gpu})
            if wname == "families":
                require(forced_walk_k2 > 0,
                        "no walk round of the families reached K2")
                require(forced_walk_k6 > 0,
                        "no walk round of the families reached K6")
    finally:
        aligner._native_cells_crossover = crossover


def phase_cluster_parity(gpu):
    """Clustering of the small family workload (write_cluster_workload)
    with the device tier from the 16th centroid on, so it takes over after
    the first 256-sequence round: --cluster_fast, --cluster_size,
    --cluster_size --strand both and --cluster_fast --mismatch -200, each
    on cuda and on cpu (the plain versions); uc and centroids must be
    byte-equal, and each cuda run must launch K4, K2 and K3 (K4, K6 and K7
    and no K2 or K3 under --mismatch -200: the top-1 prefetch) and no
    plain version.  Its forward launches are split into the walk rounds'
    and the prefetch's."""
    from vsearch_tpu_torch import cli
    from vsearch_tpu_torch.core.cluster import ClusterEngine
    from vsearch_tpu_torch.ops import cuda_lib
    d = WORK / "cparity"
    d.mkdir(parents=True, exist_ok=True)
    fa = write_cluster_workload(d)
    runs = {"fast": ["--cluster_fast", str(fa), "--id", "0.97"],
            "size": ["--cluster_size", str(fa), "--id", "0.97"],
            "size_both": ["--cluster_size", str(fa), "--id", "0.9",
                          "--strand", "both"],
            "fast_mm200": ["--cluster_fast", str(fa), "--id", "0.97"]
                          + MISMATCH_200}
    saved = ClusterEngine.DEVICE_MIN
    ClusterEngine.DEVICE_MIN = 16
    try:
        for name, args in runs.items():
            codes = "--mismatch" in args
            required = (("score_ranked",) + CODES_WIRE if codes
                        else CLUSTER_KERNELS)
            outs = {}
            for run in ("cuda", "cpu"):
                uc = d / ("%s.%s.uc" % (name, run))
                cent = d / ("%s.%s.fa" % (name, run))
                cuda_lib.reset_launches()
                with walk_round_k2() as walk:
                    rc = cli.main(args + ["--uc", str(uc), "--centroids",
                                          str(cent), "--threads", "1",
                                          "--quiet"], device=run)
                require(rc == 0, "%s failed (%s)" % (args[0], run))
                outs[run] = (uc.read_bytes(), cent.read_bytes())
                if run == "cpu":
                    continue
                launches = dict(cuda_lib.LAUNCHES)
                require(all(launches[k] > 0 for k in required),
                        "a kernel of the cluster path did not launch (%s)"
                        % name)
                require_wire(launches, codes, name)
                require(not any(cuda_lib.PLAIN_CALLS.values()),
                        "a plain version ran on the card (%s)" % name)
                emit({"phase": "cluster_parity_launches", "options": name,
                      "launches": launches,
                      "nw_rowscan_walk_rounds": walk.count,
                      "nw_rowscan_prefetch":
                          launches["nw_rowscan"] - walk.count,
                      "nw_wavefront_walk_rounds": walk.count_k6,
                      "nw_wavefront_prefetch":
                          launches["nw_wavefront"] - walk.count_k6,
                      "card": gpu})
            require(outs["cuda"] == outs["cpu"],
                    "cuda and cpu cluster outputs differ (%s)" % name)
            lines = outs["cuda"][0].splitlines()
            members = sum(1 for ln in lines if ln[:2] in (b"S\t", b"H\t"))
            require(members == 800, "uc of %s has %d S/H lines"
                    % (name, members))
            emit({"phase": "cluster_parity", "options": name, "equal": True,
                  "uc_lines": len(lines), "card": gpu})
    finally:
        ClusterEngine.DEVICE_MIN = saved


def phase_allpairs_parity(gpu):
    """allpairs_global on the 48 sequences of write_pairs_workload, seven
    option sets, each on cuda and on cpu (the plain versions): every output
    byte-equal.  The six stats-pipeline sets must launch K2m and K5 (and
    no plain version): K2m's 16-bit body, but its 32-bit body in the
    overflow set (--match 220, some pairs and not all overflowing); the
    gate set with the gate filtering pairs; --acceptall takes the generic
    path and launches neither.  Returns the overflow set's launches."""
    from vsearch_tpu_torch import cli
    from vsearch_tpu_torch.ops import cuda_lib
    d = WORK / "aparity"
    d.mkdir(parents=True, exist_ok=True)
    fa = write_pairs_workload(d / "ap48.fasta")
    option_sets = {
        "basic": ["--id", "0.5", "--blast6out", "{o}.b6", "--uc",
                  "{o}.uc"],
        "userout": ["--id", "0.45", "--userout", "{o}.user", "--userfields",
                    "query+target+id+alnlen+mism+opens+qlo+qhi+tlo+thi+raw+"
                    "caln+qcov+tcov+id3", "--output_no_hits", "--matched",
                    "{o}.m", "--notmatched", "{o}.nm"],
        "iddef0_maxhits": ["--id", "0.4", "--iddef", "0", "--maxhits", "2",
                           "--blast6out", "{o}.b6"],
        "leftjust": ["--id", "0.3", "--leftjust", "--blast6out", "{o}.b6"],
        "acceptall": ["--acceptall", "--blast6out", "{o}.b6", "--uc",
                      "{o}.uc"],
        # a match score that takes some near-identical pairs past the
        # 16-bit forward's range (K2m's overflow flag, the realign of the
        # overflow pairs) and leaves the rest inside it; both packages
        # accept it (tests/test_torch_allpairs.py runs the same set
        # against vsearch_tpu)
        "match_overflow": ["--id", "0.5", "--match", "220", "--userout",
                           "{o}.user", "--userfields",
                           "query+target+id+raw"],
        # the unaligned gate: a length ratio filters the triangle
        "minsl_gate": ["--id", "0.4", "--minsl", "0.8", "--blast6out",
                       "{o}.b6", "--uc", "{o}.uc"]}
    n_pairs = 48 * 47 // 2
    for name, opts in option_sets.items():
        outs = {}
        for run in ("cuda", "cpu"):
            tag = str(d / ("%s.%s" % (name, run)))
            files = [x.replace("{o}", tag) for x in opts]
            cuda_lib.reset_launches()
            with allpairs_counts() as counts:
                rc = cli.main(["--allpairs_global", str(fa),
                               "--minseqlength", "1", "--threads", "1",
                               "--quiet"] + files, device=run)
            require(rc == 0, "allpairs_global failed (%s, %s)"
                    % (name, run))
            outs[run] = [pathlib.Path(f).read_bytes() for f in files
                         if f.startswith(tag)]
            if run == "cpu":
                continue
            launches = dict(cuda_lib.LAUNCHES)
            require(not any(cuda_lib.PLAIN_CALLS.values()),
                    "a plain version ran on the card (%s)" % name)
            fast = name != "acceptall"
            # --match 220 is outside K2m's 16-bit envelope: its 32-bit body
            k2m = ("nw_rowscan_mr" if name == "match_overflow"
                   else "nw_rowscan_mr16")
            require((launches[k2m] > 0) == fast
                    and (launches["nw_stats"] > 0) == fast
                    and sum(launches[k] for k in K2M_BODIES)
                    == launches[k2m],
                    "K2m/K5 launches do not fit the path (%s)" % name)
            require_wire(launches, False, "allpairs " + name)
            if name == "match_overflow":
                require(0 < counts.overflow < counts.pairs,
                        "%d of %d pairs overflowed under --match 220"
                        % (counts.overflow, counts.pairs))
                match_220 = launches
            if name == "minsl_gate":
                require(0 < counts.pairs < n_pairs,
                        "the gate passed %d of %d pairs"
                        % (counts.pairs, n_pairs))
            emit({"phase": "allpairs_parity_launches", "options": name,
                  "launches": launches, **counts.record(), "card": gpu})
        require(outs["cuda"] == outs["cpu"],
                "cuda and cpu allpairs outputs differ (%s)" % name)
        emit({"phase": "allpairs_parity", "options": name, "equal": True,
              "bytes": [len(b) for b in outs["cuda"]], "card": gpu})
    # the launches of the --match 220 path, the one that takes K2m's
    # 32-bit body
    return match_220


class overflowing_forwards:
    """Keeps the inputs of the first K2 call and the first K2m call
    (nw_rowscan._forward, without and with rqT) in which a pair
    overflowed, as copies: self.kept maps nw_rowscan and nw_rowscan_mr to
    (key, qmT, amT, qlen, t4T, tlen, rqT)."""

    def __enter__(self):
        from vsearch_tpu_torch.ops import nw_rowscan
        self.kept = {}
        self._orig = forward = nw_rowscan._forward

        def keep(key, qmT, amT, qlen, t4T, tlen, rqT=None, out=None,
                 _body=None):
            res = forward(key, qmT, amT, qlen, t4T, tlen, rqT, out, _body)
            name = "nw_rowscan" if rqT is None else "nw_rowscan_mr"
            if name not in self.kept and bool(res[1].any()):
                self.kept[name] = tuple(
                    x if x is None or isinstance(x, tuple) else x.clone()
                    for x in (key, qmT, amT, qlen, t4T, tlen, rqT))
            return res

        nw_rowscan._forward = keep
        return self

    def __exit__(self, *exc):
        from vsearch_tpu_torch.ops import nw_rowscan
        nw_rowscan._forward = self._orig


def overflow_records(gpu, kept):
    """K2 and K2m on the inputs overflowing_forwards kept, with overflow
    tracking on (the route's own choice at that scheme and shape), and K3
    on K2's plane, each against its plain version: the "overflow" shapes
    of nw_rowscan, nw_rowscan_mr and nw_backtrack."""
    import torch
    from vsearch_tpu_torch.ops import nw_batch, nw_rowscan
    out = []
    for name in ("nw_rowscan", "nw_rowscan_mr"):
        require(name in kept, "no %s call of phase 3's --mismatch 100 runs "
                "flagged an overflowing pair" % name)
        key, qmT, amT, qlen, t4T, tlen, rqT = kept[name]
        M, B = qmT.shape
        N = t4T.shape[0]
        require(nw_rowscan.overflow_possible(key, M, N)
                and not nw_rowscan.rowscan16(key, M, N),
                "%s does not track overflow at %d x %d" % (name, M, N))
        got = nw_rowscan._forward(key, qmT, amT, qlen, t4T, tlen, rqT)
        want = nw_rowscan.forward_plain(
            key, nw_rowscan._scheme(key).score_min(), True, qmT, amT, qlen,
            t4T, tlen, rqT)
        torch.cuda.synchronize()
        err = max(max_abs_err(g, w) for g, w in zip(got, want))
        require(err == 0, "%s differs from its plain version with overflow "
                "tracking" % name)
        out.append({"kernel": name + "_overflow",
                    "shape": {"B": B, "M": M, "N": N,
                              "overflowing": int(got[1].sum())},
                    "max_abs_err": err, "card": gpu})
        emit(out[-1])
        if name == "nw_rowscan":
            ops_k = nw_batch.backtrack_rle(got[2], qlen, tlen)
            ops_p = nw_batch.backtrack_rle_plain(got[2], qlen, tlen)
            torch.cuda.synchronize()
            err = max_abs_err(ops_k, ops_p)
            require(err == 0, "K3 differs from its plain version on an "
                    "overflowing K2 plane")
            out.append({"kernel": "nw_backtrack_overflow",
                        "shape": {"B": B, "M": M, "N": N},
                        "max_abs_err": err, "card": gpu})
            emit(out[-1])
    return out


def phase_overflow_parity(gpu):
    """--match 1 --mismatch 100 on tests/overflow_workload.py (400-520 nt,
    near-all-mismatch pairs among them), a scheme whose alignments pass
    SHRT_MAX: usearch_global with every walk round on the device aligner
    and allpairs_global, each on cuda and on cpu, uc, blast6 and userout
    byte-equal.  Each cuda run must flag overflowing pairs (the aligner's
    SHRT_MAX sentinels; allpairs also K2m's overflow flags) and launch no
    plain version: search K1, K2 and K3, allpairs K2m's 32-bit body (a
    mismatch of 100 is outside the 16-bit body's [-64, 63]) and K5.
    The inputs of a K2 call and a K2m call of the cuda runs in which a
    pair overflowed are then held against the plain versions
    (overflow_records).  Returns the launches of the two cuda runs and
    those records."""
    from tests.overflow_workload import (ARGS, count_overflow,
                                         write_overflow_workload)
    from vsearch_tpu_torch import cli
    from vsearch_tpu_torch.ops import cuda_lib, nw_batch
    d = WORK / "overflow"
    d.mkdir(parents=True, exist_ok=True)
    db, q, ap = write_overflow_workload(d)
    runs = {
        "usearch_global_mismatch_100": (
            ["--usearch_global", str(q), "--db", str(db), "--id", "0.01",
             "--maxaccepts", "2", "--maxrejects", "4", "--output_no_hits"],
            SEARCH_KERNELS),
        "allpairs_global_mismatch_100": (
            ["--allpairs_global", str(ap), "--id", "0.01",
             "--minseqlength", "1"], ("nw_rowscan_mr", "nw_stats"))}
    aligner = nw_batch.BatchAligner
    crossover = aligner._native_cells_crossover
    out = {}
    kept = {}
    try:
        aligner._native_cells_crossover = lambda self: 0
        for name, (args, required) in runs.items():
            outs = {}
            for run in ("cuda", "cpu"):
                tag = str(d / ("%s.%s" % (name, run)))
                files = [tag + ".uc", tag + ".b6", tag + ".user"]
                cuda_lib.reset_launches()
                t0 = time.perf_counter()
                seen, undo = count_overflow()
                try:
                    with overflowing_forwards() as fwd:
                        rc = cli.main(args + ARGS + [
                            "--uc", files[0], "--blast6out", files[1],
                            "--userout", files[2], "--userfields",
                            "query+target+id+raw+mism+gaps+qlo+qhi+tlo+thi+"
                            "caln", "--threads", "1", "--quiet"], device=run)
                finally:
                    undo()
                require(rc == 0, "%s failed (%s)" % (name, run))
                outs[run] = [pathlib.Path(f).read_bytes() for f in files]
                if run == "cpu":
                    continue
                launches = dict(cuda_lib.LAUNCHES)
                require(all(launches[k] > 0 for k in required)
                        and launches["nw_rowscan_mr16"] == 0,
                        "a kernel of the %s path did not launch" % name)
                require(not any(cuda_lib.PLAIN_CALLS.values()),
                        "a plain version ran on the card (%s)" % name)
                require_wire(launches, False, name)
                require(seen["aligner_sentinels"] > 0
                        and (seen["allpairs_overflow"] > 0
                             or name.startswith("usearch")),
                        "no pair overflowed (%s)" % name)
                out[name] = launches
                for k, v in fwd.kept.items():
                    kept.setdefault(k, v)
                emit({"phase": "overflow_parity_launches", "options": name,
                      "seconds": time.perf_counter() - t0,
                      "launches": launches, **seen, "card": gpu})
            require(outs["cuda"] == outs["cpu"] and all(outs["cuda"]),
                    "cuda and cpu outputs differ (%s)" % name)
            emit({"phase": "overflow_parity", "options": name,
                  "equal": True, "bytes": [len(b) for b in outs["cuda"]],
                  "card": gpu})
    finally:
        aligner._native_cells_crossover = crossover
    return out, overflow_records(gpu, kept)


def phase_chimera_parity(gpu):
    """The five chimera verbs on the seeded chimera workload (800
    sequences; chimeras_denovo also with tests/data/chimeras_long.fasta
    appended), uchime_ref against its 520-sequence DB and
    --uchime3_denovo --mismatch -200, with the de novo device tier from
    the 16th accepted reference on: after a host round of 128 queries
    the growing index scores rounds of 128, 512 and 32 queries, the 512
    one in several K4 chunks, resolved one round deep.  Each case runs
    on cuda with every alignment call forced onto the device aligner
    (crossover 0) and on cpu (the plain K4/K1, every alignment on the
    host C tier), every output byte-equal.  Each cuda run must launch K4 (de
    novo) or K1 (uchime_ref) and K2 and K3 (K6 and K7 and no K2 or K3
    under --mismatch -200), and no plain version."""
    from tests.chimera_workload import write_ref_workload
    from vsearch_tpu_torch import cli
    from vsearch_tpu_torch.core.chimera import ChimeraEngine
    from vsearch_tpu_torch.ops import cuda_lib, nw_batch
    d = WORK / "chparity"
    d.mkdir(parents=True, exist_ok=True)
    fa, q, db = write_ref_workload(d)
    long_fa = d / "long.fa"
    long_fa.write_bytes(fa.read_bytes() + (
        REPO / "tests" / "data" / "chimeras_long.fasta").read_bytes())
    uchime = ("uchimeout", "uchimealns", "chimeras", "nonchimeras",
              "borderline")
    longouts = ("alnout", "tabbedout", "chimeras", "nonchimeras")
    cases = {"uchime_denovo": (["--uchime_denovo", str(fa)], uchime),
             "uchime2_denovo": (["--uchime2_denovo", str(fa)], uchime),
             "uchime3_denovo": (["--uchime3_denovo", str(fa)], uchime),
             "chimeras_denovo": (["--chimeras_denovo", str(fa)], longouts),
             "chimeras_denovo_long": (["--chimeras_denovo", str(long_fa)],
                                      longouts),
             "uchime_ref": (["--uchime_ref", str(q), "--db", str(db)],
                            uchime),
             "uchime3_denovo_mm200": (["--uchime3_denovo", str(fa)]
                                      + MISMATCH_200, uchime)}
    aligner = nw_batch.BatchAligner
    crossover = aligner._native_cells_crossover
    saved = ChimeraEngine.DEVICE_MIN
    ChimeraEngine.DEVICE_MIN = 16
    try:
        for name, (args, outs) in cases.items():
            codes = "--mismatch" in args
            scoring = "score_dense" if "--uchime_ref" in args \
                else "score_ranked"
            required = (scoring,) + (CODES_WIRE if codes else ROW_WIRE)
            got = {}
            for run in ("cuda", "cpu"):
                aligner._native_cells_crossover = (
                    (lambda self: 0) if run == "cuda"
                    else (lambda self: float("inf")))
                files = [str(d / ("%s.%s.%s" % (name, run, o)))
                         for o in outs]
                cuda_lib.reset_launches()
                with walk_round_k2() as walk:
                    rc = cli.main(args + [x for o, f in zip(outs, files)
                                          for x in ("--" + o, f)]
                                  + CHIM_ARGS, device=run)
                require(rc == 0, "%s failed (%s)" % (args[0], run))
                got[run] = [pathlib.Path(f).read_bytes() for f in files]
                if run == "cpu":
                    continue
                launches = dict(cuda_lib.LAUNCHES)
                require(all(launches[k] > 0 for k in required),
                        "a kernel of the chimera path did not launch (%s)"
                        % name)
                require_wire(launches, codes, "chimera " + name)
                require(not any(cuda_lib.PLAIN_CALLS.values()),
                        "a plain version ran on the card (%s)" % name)
                emit({"phase": "chimera_parity_launches", "options": name,
                      "launches": launches,
                      "nw_rowscan_walk_rounds": walk.count,
                      "nw_wavefront_walk_rounds": walk.count_k6,
                      "card": gpu})
            require(got["cuda"] == got["cpu"],
                    "cuda and cpu chimera outputs differ (%s)" % name)
            nonchim = got["cuda"][outs.index("nonchimeras")]
            require(nonchim.count(b">") > 0,
                    "no non-chimeras (%s)" % name)
            emit({"phase": "chimera_parity", "options": name, "equal": True,
                  "bytes": dict(zip(outs, map(len, got["cuda"]))),
                  "card": gpu})
    finally:
        ChimeraEngine.DEVICE_MIN = saved
        aligner._native_cells_crossover = crossover


def phase_chimera_full(gpu, chim_path):
    """The chimera cell: tools/bench_scale.py's uchime3_denovo_50k shape
    through --uchime3_denovo --chimeras --nonchimeras --borderline with
    the production DEVICE_MIN, timed once with the launches read around
    it, then the same run under torch.profiler with K4's device ms a
    launch.  Both print the host's time by pipeline phase.  K4 is then held
    against its plain version on the largest chunk of the traced run
    (record "score_ranked_chimera"), K2 and K3 on the largest alignment
    wave the timed run sent to the card, or its largest alignment call
    sent there afterwards where the router kept every call on the host
    (records "nw_rowscan_chimera" and "nw_backtrack_chimera").  Returns
    (launches, records)."""
    import torch
    from vsearch_tpu_torch import cli
    from vsearch_tpu_torch.ops import cuda_lib
    from vsearch_tpu_torch.ops.nw import ScoreScheme
    from vsearch_tpu_torch.ops.nw_batch import BatchAligner
    from vsearch_tpu_torch.utils import phasetimer
    n_seqs = 4 * CHIM_FAMILIES
    argv = ["--uchime3_denovo", str(chim_path)] + CHIM_ARGS
    outs = ("chimeras", "nonchimeras", "borderline")

    def run(tag):
        fresh_router(argv)
        t0 = time.perf_counter()
        rc = cli.main(argv + [x for o in outs for x in
                              ("--" + o, str(WORK / ("%s.%s" % (tag, o))))],
                      device="cuda")
        torch.cuda.synchronize()
        require(rc == 0, "uchime3_denovo failed")
        return time.perf_counter() - t0

    start_crossover = fresh_router(argv)
    phasetimer.ENABLED = True
    phasetimer.reset()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    with walk_round_k2() as walk, largest_wave() as wave:
        elapsed = run("chimera")
    launches = dict(cuda_lib.LAUNCHES)
    host_phase_s = dict(phasetimer.acc)
    end_crossover = crossover(argv)
    require(not any(cuda_lib.PLAIN_CALLS.values()),
            "a plain version ran on the chimera path")
    require(launches["score_ranked"] > 0,
            "K4 was not launched on the chimera path")
    require_wire(launches, False, "chimera_full")
    heads = {o: fasta_heads(WORK / ("chimera.%s" % o)) for o in outs}
    every = sorted(h for hs in heads.values() for h in hs)
    require(every == sorted(fasta_heads(chim_path)),
            "the outputs do not hold each input once")
    require(len(every) == n_seqs, "the outputs hold %d records"
            % len(every))
    emit({"phase": "chimera_full", "sequences": n_seqs,
          "seq_len": AMP_LEN, "seconds": elapsed,
          "sequences_per_s": n_seqs / elapsed,
          "records": {o: len(h) for o, h in heads.items()},
          "launches": launches,
          "nw_rowscan_walk_rounds": walk.count,
          "nw_wavefront_walk_rounds": walk.count_k6,
          "crossover_cells_start": start_crossover,
          "crossover_cells_end": end_crossover,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "host_phase_s": host_phase_s, "card": gpu})
    phasetimer.reset()
    k4_name = "score_kernel<2>"              # EPI_RANK_KEY
    with ranked_words(keep=True) as scanned:
        traced = trace(lambda: run("chimera_traced"),
                       match=(k4_name, "nw_rowscan", "nw_backtrack"))
    phasetimer.ENABLED = False
    # the device tier's rounds follow from the accepted references alone,
    # not from the router: the traced run makes the timed run's K4 launches
    require(scanned.launches == launches["score_ranked"],
            "the traced run made %d K4 launches, the timed run %d"
            % (scanned.launches, launches["score_ranked"]))
    k4 = traced["device_ms_matching"][k4_name]
    emit(dict({"phase": "chimera_full_traced"}, **traced,
              score_ranked_ms=k4, score_ranked_launches=scanned.launches,
              score_ranked_ms_per_launch=k4 / max(1, scanned.launches),
              score_ranked_mean_words=scanned.words
              / max(1, scanned.launches),
              host_phase_s=dict(phasetimer.acc), card=gpu))
    # K4 on the run's largest chunk (query rows x words scanned), at the
    # index's row stride
    Kbits, bits, rank = scanned.largest
    del scanned
    shifts = torch.arange(32, dtype=torch.int32, device=Kbits.device)
    nnz = int(((Kbits[:, :, None] >> shifts) & 1).sum())
    records = [ranked_record(gpu, "score_ranked_chimera", Kbits, bits, rank,
                             nnz, {"row_stride": bits.stride(0)})]
    del Kbits, bits, rank
    torch.cuda.empty_cache()
    # K2 and K3 on the timed run's largest wave on the card; where the
    # router sent every call to the host, on its largest alignment call,
    # sent to the card here
    scheme = ScoreScheme.from_params(cli.parse_args(argv))
    aligner = BatchAligner(scheme, torch.device("cuda"))
    args, routed = wave.args, "card"
    if args is None:
        require(wave.call is not None, "the chimera path aligned nothing")
        cap = BatchAligner.PAIR_BUCKETS[-1]
        with largest_wave() as sent:
            aligner._dispatch(wave.call[0][:cap], wave.call[1][:cap])
        args, routed = sent.args, "host"
    emit({"phase": "chimera_wave", "routed_to": routed,
          "B": args[0].shape[1], "M": args[0].shape[0],
          "N": args[3].shape[0], "card": gpu})
    records += nw_records(gpu, aligner._key, scheme, args, "_chimera")
    return launches, records


def phase_api_parity(gpu):
    """The session API (tests/api_sessions.py) on cuda and on cpu: the
    search session over write_parity_workload's 520 references
    (SearchSession.search on each of the 64 queries, a batch of one each,
    then search_batch on all 64 as one batch), the chimera session over the
    chimera workload's queries against its 520 references
    (ChimeraSession.detect) and the cluster session over a small family set
    sorted by length (ClusterSession.assign on every sequence).  The
    results, as JSON, must be equal.  On cuda the search session must
    launch K1, K2 and K3 and the chimera session K1, and neither a plain
    version."""
    from tests import api_sessions
    from tests.chimera_workload import write_ref_workload
    from vsearch_tpu_torch import api
    from vsearch_tpu_torch.ops import cuda_lib
    from vsearch_tpu_torch.params import Parameters
    d = WORK / "apiparity"
    d.mkdir(parents=True, exist_ok=True)
    db, q = write_parity_workload(d)
    _, chim_q, chim_db = write_ref_workload(d)
    clu = api_sessions.write_cluster_set(d / "clu.fa")
    sessions = {
        "search": (lambda dev: api_sessions.search(
            api, Parameters, db, q, dev, n_single=64), SEARCH_KERNELS),
        "chimera": (lambda dev: api_sessions.chimera(
            api, Parameters, chim_q, chim_db, dev), ("score_dense",)),
        "cluster": (lambda dev: api_sessions.cluster(
            api, Parameters, clu, dev), ())}
    for name, (call, required) in sessions.items():
        got = {}
        for run in ("cuda", "cpu"):
            cuda_lib.reset_launches()
            t0 = time.perf_counter()
            got[run] = call(run)
            seconds = time.perf_counter() - t0
            launches = dict(cuda_lib.LAUNCHES)
            if run == "cuda":
                require(all(launches[k] > 0 for k in required),
                        "a kernel of the %s session did not launch" % name)
                require(not any(cuda_lib.PLAIN_CALLS.values()),
                        "a plain version ran on the card (%s session)"
                        % name)
                require_wire(launches, False, "api " + name)
            emit({"phase": "api_parity_run", "session": name, "run": run,
                  "seconds": seconds, "launches": launches, "card": gpu})
        require(got["cuda"] == got["cpu"],
                "cuda and cpu %s session results differ" % name)
        if name == "search":
            require(len(got["cuda"]["batch"]) == 64
                    and got["cuda"]["single"] == [
                        row[:3] for row in got["cuda"]["batch"]],
                    "search and search_batch disagree")
        emit({"phase": "api_parity", "session": name, "equal": True,
              "results": len(got["cuda"]["batch"] if name == "search"
                             else got["cuda"]), "card": gpu})


def phase_pipeline_parity(gpu):
    """The amplicon workflow of tests/amplicon_workload.py on its seeded
    4000 pairs through the CLI, each step's outputs feeding the next
    (--fastq_mergepairs, --fastq_filter --fastq_maxee 1, --fastx_uniques,
    --cluster_unoise, --uchime3_denovo, --usearch_global --otutabout,
    --sintax), once on cuda as the aligner routes it and once on cpu with
    every alignment on the host C tier.  Every step's outputs must be
    byte-equal; each step's seconds and each device step's launches are
    printed."""
    from tests.amplicon_workload import (DEVICE_STEPS, pipeline_steps,
                                         write_amplicon_workload)
    from vsearch_tpu_torch import cli
    from vsearch_tpu_torch.ops import cuda_lib, nw_batch
    d = WORK / "pipeline"
    d.mkdir(parents=True, exist_ok=True)
    steps = pipeline_steps(*write_amplicon_workload(d))
    aligner = nw_batch.BatchAligner
    crossover = aligner._native_cells_crossover
    here = os.getcwd()
    seconds = {}
    try:
        for run in ("cuda", "cpu"):
            wd = d / run
            wd.mkdir(exist_ok=True)
            os.chdir(wd)
            aligner._native_cells_crossover = (
                crossover if run == "cuda" else (lambda self: float("inf")))
            seconds[run] = {}
            for name, argv, _ in steps:
                fresh_router(argv)
                cuda_lib.reset_launches()
                t0 = time.perf_counter()
                rc = cli.main(argv + ["--threads", "1", "--quiet"],
                              device=run)
                seconds[run][name] = time.perf_counter() - t0
                require(rc == 0, "pipeline step %s failed (%s)"
                        % (name, run))
                if run == "cuda":
                    require(not any(cuda_lib.PLAIN_CALLS.values()),
                            "a plain version ran on the card (%s)" % name)
                    if name in DEVICE_STEPS:
                        emit({"phase": "pipeline_launches", "step": name,
                              "launches": dict(cuda_lib.LAUNCHES),
                              "card": gpu})
    finally:
        os.chdir(here)
        aligner._native_cells_crossover = crossover
    for name, _, outs in steps:
        for o in outs:
            require((d / "cuda" / o).read_bytes()
                    == (d / "cpu" / o).read_bytes(),
                    "cuda and cpu pipeline outputs differ (%s)" % o)
    zotus = (d / "cuda" / "zotus_nc.fa").read_bytes().count(b">")
    chimeras = (d / "cuda" / "zotus_ch.fa").read_bytes().count(b">")
    otus = (d / "cuda" / "otutab.tsv").read_bytes().count(b"\n") - 1
    require(zotus > 0 and chimeras > 0 and otus == zotus,
            "%d ZOTUs, %d chimeras, %d OTU table rows"
            % (zotus, chimeras, otus))
    emit({"phase": "pipeline", "equal": True, "zotus": zotus,
          "chimeras": chimeras, "seconds": seconds, "card": gpu})


def phase_multiblock_parity(gpu):
    """The multi-block merge: usearch_global of MB_QUERIES queries against
    MB_DB sequences of MB_LEN nt (generate's dataset at that size), more
    than two of DeviceKmerIndex.BLOCK_POS positions, so that the device
    index scores three blocks and merges them exactly
    (ops/score_dense.merge_blocks).  On cuda and on cpu, uc and blast6
    byte-equal, the cuda run launching K1 once a block.  The sharded phase
    runs it again at two ranks, whose shards hold two blocks each.
    Returns the dataset's paths and the cuda run's outputs."""
    from vsearch_tpu_torch import cli
    from vsearch_tpu_torch.ops import cuda_lib
    from vsearch_tpu_torch.ops.score import DeviceKmerIndex
    d = WORK / "multiblock"
    d.mkdir(parents=True, exist_ok=True)
    db, q = generate(d, MB_DB, MB_QUERIES, MB_LEN)
    blocks = -(-MB_DB // DeviceKmerIndex.BLOCK_POS)
    outs, seconds = {}, {}
    for run in ("cuda", "cpu"):
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(["--usearch_global", str(q), "--db", str(db), "--uc",
                       str(d / ("%s.uc" % run)), "--blast6out",
                       str(d / ("%s.b6" % run))] + MB_ARGS, device=run)
        seconds[run] = time.perf_counter() - t0
        require(rc == 0, "usearch_global failed (multi-block, %s)" % run)
        outs[run] = [(d / ("%s.%s" % (run, o))).read_bytes()
                     for o in ("uc", "b6")]
        if run == "cuda":
            launches = dict(cuda_lib.LAUNCHES)
            require(not any(cuda_lib.PLAIN_CALLS.values()),
                    "a plain version ran on the card (multi-block)")
            require(launches["score_dense"] == blocks,
                    "K1 launched %d times on %d blocks"
                    % (launches["score_dense"], blocks))
    require(outs["cuda"] == outs["cpu"],
            "cuda and cpu outputs differ (multi-block)")
    hits = sum(1 for ln in outs["cuda"][0].splitlines()
               if ln.startswith(b"H\t"))
    require(hits > 0, "the multi-block search found nothing")
    emit({"phase": "multiblock_parity", "db": MB_DB, "seq_len": MB_LEN,
          "queries": MB_QUERIES, "blocks": blocks, "hits": hits,
          "equal": True, "launches": launches, "seconds": seconds,
          "card": gpu})
    return db, q, d / "cuda.uc", d / "cuda.b6"


def run_ranks(spec_path: pathlib.Path, ranks: int, timeout: int):
    """tests/parallel_driver.py under torchrun, its process group in its
    own session so that a timeout stops every rank.  Returns the ranks'
    reports."""
    env = dict(os.environ)
    env.pop("VSEARCH_TPU_TORCH_DEVICE", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(ranks),
         str(REPO / "tests" / "parallel_driver.py"), str(spec_path)],
        cwd=spec_path.parent, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        raise RuntimeError("chip_smoke: the sharded run passed %d s"
                           % timeout)
    require(proc.returncode == 0, "the sharded run failed:\n" + log[-6000:])
    spec = json.loads(spec_path.read_text())
    return [json.loads(pathlib.Path("%s.rank%d.json" % (spec["report"], r))
                       .read_text()) for r in range(ranks)]


def sharded_runs(db_path, q_path, amp_path, chim_path, mb_db, mb_q, mb_uc,
                 mb_b6):
    """The sharded phase's runs, each against the single-process cuda run
    of the same input: the full-width search, chimera and clustering cells
    of phase 4 as routed, and at phase 3's sizes with every alignment call
    on the card, the families' --mismatch -200 search, uchime_ref and the
    multi-block search."""
    d = WORK / "sharded"
    par, chp = WORK / "parity", WORK / "chparity"
    chim_outs = ("chimeras", "nonchimeras", "borderline")
    uchime = ("uchimeout", "uchimealns", "chimeras", "nonchimeras",
              "borderline")
    fq, fdb = par / "fq.fasta", par / "fdb.fasta"
    return {
        "sharded_usearch_global": (
            ["--usearch_global", str(q_path), "--db", str(db_path), "--uc",
             str(d / "full.uc")] + FULL_ARGS,
            {d / "full.uc": WORK / "full.uc"}, SHARDED_FRESH,
            SEARCH_KERNELS, "ShardedKmerIndex"),
        "sharded_uchime3_denovo": (
            ["--uchime3_denovo", str(chim_path)] + CHIM_ARGS
            + [x for o in chim_outs for x in ("--" + o, str(d / ("chimera."
                                                                 + o)))],
            {d / ("chimera." + o): WORK / ("chimera." + o)
             for o in chim_outs}, SHARDED_FRESH, ("score_ranked",),
            "ShardedGrowingKmerIndex"),
        "sharded_cluster_size": (
            ["--cluster_size", str(amp_path), "--uc", str(d / "cluster.uc"),
             "--centroids", str(d / "cluster.fa")] + CLUSTER_ARGS,
            {d / "cluster.uc": WORK / "cluster.uc",
             d / "cluster.fa": WORK / "cluster.fa"}, SHARDED_FRESH,
            CLUSTER_KERNELS, "ShardedGrowingKmerIndex"),
        "sharded_usearch_global_mismatch_200": (
            ["--usearch_global", str(fq), "--db", str(fdb), "--uc",
             str(d / "mm200.uc"), "--blast6out", str(d / "mm200.b6"),
             "--threads", "1", "--quiet", "--id", "0.8", "--maxaccepts", "4",
             "--maxrejects", "8"] + MISMATCH_200,
            {d / "mm200.uc": par / "families.mm200.cuda_forced.uc",
             d / "mm200.b6": par / "families.mm200.cuda_forced.b6"},
            SHARDED_FORCED, SEARCH_200_KERNELS, "ShardedKmerIndex"),
        "sharded_uchime_ref": (
            ["--uchime_ref", str(chp / "ref_q.fa"), "--db",
             str(chp / "ref_db.fa")] + CHIM_ARGS
            + [x for o in uchime for x in ("--" + o, str(d / ("ref." + o)))],
            {d / ("ref." + o): chp / ("uchime_ref.cuda." + o)
             for o in uchime}, SHARDED_FORCED,
            ("score_dense",) + ROW_WIRE, "ShardedKmerIndex"),
        "sharded_multiblock": (
            ["--usearch_global", str(mb_q), "--db", str(mb_db), "--uc",
             str(d / "mb.uc"), "--blast6out", str(d / "mb.b6")] + MB_ARGS,
            {d / "mb.uc": mb_uc, d / "mb.b6": mb_b6}, SHARDED_FRESH,
            SEARCH_KERNELS, "ShardedKmerIndex"),
    }


def phase_sharded(gpu, runs, ranks=SHARDED_RANKS, shared_card=True):
    """The sharded path: every run of ``runs`` ({name: (argv, outputs as
    {this run's path: the single-process cuda run's}, setup, kernels,
    sharded class)}) at ``ranks`` ranks (tests/parallel_driver.py under
    torchrun), each under torch.profiler, those of SHARDED_WARM after an
    untraced warm-up.  With ``shared_card`` every rank runs on cuda:0 over
    gloo, else rank r on cuda:r over nccl (tools/multicard.py).
    Every output must be byte-equal to the single-process cuda run's; in
    each rank every kernel of the run's path must launch, no plain
    version run, the sharded class be built and a collective run; no
    rank may load jax or vsearch_tpu.  Prints each run's wall, launches,
    collectives and device idle share by rank, before the checks; returns
    each run's launches summed over the ranks."""
    d = WORK / "sharded"
    d.mkdir(parents=True, exist_ok=True)
    spec = d / "spec.json"
    # nothing named: each rank takes cuda:LOCAL_RANK and nccl
    placement = ({"backend": "gloo", "device": "cuda:0"} if shared_card
                 else {})
    spec.write_text(json.dumps(dict(placement, **{
        "setup": SHARDED_SETUP, "report": str(d / "report"),
        "runs": [run for name, (argv, _, setup, _, _) in runs.items()
                 for run in ([{"name": name + "_warm", "setup": setup,
                               "argv": argv}] if name in SHARDED_WARM
                             else []) + [{"name": name, "setup": setup,
                                          "argv": argv, "trace": True}]]})))
    t0 = time.perf_counter()
    reports = run_ranks(spec, ranks, SHARDED_TIMEOUT)
    wall = time.perf_counter() - t0
    by_path = {}
    for name, (_, outs, _, kernels, cls) in runs.items():
        per_rank = [next(r for r in rep["runs"] if r["name"] == name)
                    for rep in reports]
        # the index classes built by the run and its warm-up
        built = [dict(run["built"], **next(
            (r["built"] for r in rep["runs"] if r["name"] == name + "_warm"),
            {})) for rep, run in zip(reports, per_rank)]
        emit({"phase": "sharded", "run": name, "ranks": ranks,
              "seconds": [run["seconds"] for run in per_rank],
              "launches": [run["launches"] for run in per_rank],
              "collectives": [run["collectives"] for run in per_rank],
              "built": built,
              "device_idle_share": [run.get("device_idle_share")
                                    for run in per_rank],
              "device_busy_ms": [run.get("device_busy_ms")
                                 for run in per_rank],
              "card": gpu})
        for rep, run, b in zip(reports, per_rank, built):
            what = "%s, rank %d" % (name, rep["rank"])
            require(not rep["foreign_modules"],
                    "jax or vsearch_tpu loaded (%s)" % what)
            require(run["result"] == 0, "the run failed (%s)" % what)
            require(all(run["launches"][k] > 0 for k in kernels),
                    "a kernel of the path did not launch (%s): %s"
                    % (what, run["launches"]))
            require(not any(run["plain_calls"].values()),
                    "a plain version ran (%s)" % what)
            require(b.get(cls, 0) > 0, "%s was not built (%s)" % (cls, what))
            require(run["collectives"]["all_gather"] > 0,
                    "no collective ran (%s)" % what)
            require(run["device"] == "cuda:%d" % (0 if shared_card
                                                  else rep["rank"]),
                    "rank %d on %s" % (rep["rank"], run["device"]))
        for mine, ref in outs.items():
            require(pathlib.Path(mine).read_bytes()
                    == pathlib.Path(ref).read_bytes(),
                    "sharded and single-process outputs differ (%s, %s)"
                    % (name, pathlib.Path(ref).name))
        by_path[name] = {k: sum(run["launches"][k] for run in per_rank)
                         for k in per_rank[0]["launches"]}
    emit({"phase": "sharded_total", "seconds": wall, "card": gpu})
    return by_path


def phase_api_full(gpu, db_path, q_path):
    """The search cell through the session API: a SearchSession over the
    bench dataset (read_database, the parameters of FULL_ARGS), then
    search_batch on the 2000 queries as one batch: once to warm up, once
    timed with the launch counts read around it, API_REPS - 1 times more
    timed, once under torch.profiler with the host's time by pipeline
    phase.  Each result row must match the uc line of the CLI's
    run of the same cell (phase_full's full.uc): no row for an N line, the
    target and CIGAR of an H line ("=" a CIGAR of matches only)."""
    import torch
    from tests.api_sessions import read_fasta
    from vsearch_tpu_torch import api, cli
    from vsearch_tpu_torch.ops import cuda_lib
    from vsearch_tpu_torch.utils import phasetimer
    argv = ["--usearch_global", str(q_path), "--db", str(db_path), "--uc",
            os.devnull] + FULL_ARGS
    params = cli.parse_args(argv)
    queries = [(h, s, 1) for h, s in read_fasta(q_path)]
    t0 = time.perf_counter()
    with api.session(params, device="cuda"):
        db, index = api.read_database(str(db_path), params)
        with api.SearchSession(params, db, index) as ss:
            build = time.perf_counter() - t0

            def run():
                fresh_router(argv)
                t0 = time.perf_counter()
                rows = ss.search_batch(queries)
                torch.cuda.synchronize()
                return time.perf_counter() - t0, rows

            run()
            cuda_lib.reset_launches()
            with walk_round_k2() as walk:
                elapsed, rows = run()
            launches = dict(cuda_lib.LAUNCHES)
            # more timed calls: the host's clock varies from call to call
            again = [run()[0] for _ in range(API_REPS - 1)]
            phasetimer.ENABLED = True
            phasetimer.reset()
            traced = trace(lambda: run()[0])
            phasetimer.ENABLED = False
    require(not any(cuda_lib.PLAIN_CALLS.values()),
            "a plain version ran on the API search path")
    for name in SEARCH_KERNELS:
        require(launches[name] > 0,
                "kernel %s was not launched on the API search path" % name)
    require_wire(launches, False, "api_full")
    require(len(rows) == N_QUERIES, "%d result rows" % len(rows))
    uc = (WORK / "full.uc").read_bytes().splitlines()
    require(len(uc) == N_QUERIES, "uc has %d lines" % len(uc))
    hits = 0
    for row, line in zip(rows, uc):
        f = line.split(b"\t")
        if f[0] == b"N":
            require(not row, "a result for the no-hit query %s" % f[8])
            continue
        require(len(row) == 1, "%d results for %s" % (len(row), f[8]))
        r = row[0]
        cigar = f[7].decode()
        require(db.getheader(r.target) == f[9]
                and (r.cigar == cigar if cigar != "="
                     else r.cigar.rstrip("0123456789M") == ""),
                "the result for %s differs from its uc line" % f[8])
        hits += 1
    emit({"phase": "api_full", "queries": N_QUERIES, "db": DB_SIZE,
          "seq_len": SEQ_LEN, "session_build_seconds": build,
          "seconds": elapsed, "queries_per_s": N_QUERIES / elapsed,
          "seconds_again": again, "hits": hits, "launches": launches,
          "nw_rowscan_walk_rounds": walk.count, "card": gpu})
    emit(dict({"phase": "api_full_traced"}, **traced,
              host_phase_s=dict(phasetimer.acc), card=gpu))
    phasetimer.reset()
    return launches


def phase_capi(gpu, db_path, q_path):
    """The C-ABI embedding shim (vsearch_tpu_torch/csrc/capi.c, built by
    vsearch_tpu_torch/capi.py with its demo, csrc/capi_demo.c, and the
    two-thread embedder tests/capi_threads.c), over the bench dataset's
    first CAPI_QUERIES queries (--id 0.9, maxaccepts 1, maxrejects 32 and
    wordlength 8), each one vstpu_search_single call: the demo, a
    subprocess on the card, must print the rows of SearchSession.search
    in this process on the same queries with the same parameters.  Then
    the shim is loaded into this process (it finds the interpreter
    running) and sends the same queries, each call timed, with the launch
    counts read around that run: it must launch K1, K2 and K3 and no plain
    version and give the demo's rows.  On write_parity_workload the demo
    on cuda and with VSEARCH_TPU_TORCH_DEVICE=cpu, and the two-thread
    embedder on cuda, must print the same rows; the shim in this process
    drives vstpu_* on the same workload from this thread and then from a
    new one: each run must launch K1, K2 and K3 and no plain version and
    print the demo's rows; a second vstpu_session_begin inside the
    session must return -1.  Returns the launches of the timed run."""
    import threading
    from tests import capi_sessions
    from tests.api_sessions import read_fasta
    from vsearch_tpu_torch import api, capi, device
    from vsearch_tpu_torch.ops import cuda_lib
    from vsearch_tpu_torch.params import Parameters
    d = WORK / "capi"
    d.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    _, demo = capi.build()
    threads_exe = capi.compile_embedder(REPO / "tests" / "capi_threads.c",
                                        d / "capi_threads")
    emit({"phase": "capi_build", "seconds": time.perf_counter() - t0,
          "card": gpu})
    opts = ["%s=%s" % kv for kv in capi_sessions.OPTIONS.items()
            if kv[0] != "id"]
    env = capi.embed_env()
    env.pop(device.ENV, None)

    def start(exe, db, q, **extra):
        return (exe, time.perf_counter(), subprocess.Popen(
            [str(exe), str(db), str(q), "0.9"] + opts, env=dict(env, **extra),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))

    def finish(started):
        exe, t0, proc = started
        try:
            out, err = proc.communicate(timeout=CAPI_TIMEOUT)
        finally:
            proc.kill()
        require(proc.returncode == 0, "%s failed: %s" % (
            exe.name, err.decode(errors="replace")[-3000:]))
        return out, time.perf_counter() - t0

    def run(*a, **k):
        return finish(start(*a, **k))

    def check_launches(launches, who):
        require(all(launches[k] > 0 for k in SEARCH_KERNELS),
                "a kernel of the search path did not launch through the "
                "C ABI (%s)" % who)
        require(not any(cuda_lib.PLAIN_CALLS.values()),
                "a plain version ran through the C ABI (%s)" % who)
        require_wire(launches, False, "capi " + who)

    # full width: the demo against SearchSession.search in process
    queries = read_fasta(q_path)[:CAPI_QUERIES]
    full_q = d / "queries.fasta"
    full_q.write_bytes(b"".join(b">%s\n%s\n" % r for r in queries))
    rows, wall = run(demo, db_path, full_q)
    p = Parameters()
    for name, value in capi_sessions.OPTIONS.items():
        setattr(p, "opt_" + name, value)
    t0 = time.perf_counter()
    with api.session(p):
        db, index = api.read_database(str(db_path), p)
        with api.SearchSession(p, db, index) as ss:
            hits = [[{"target_label": db.getheader(h.target).decode(
                          "latin-1"), "id": h.id, "matches": h.matches,
                      "mismatches": h.mismatches, "gaps": h.gaps}
                     for h in ss.search(head, seq)]
                    for head, seq in queries]
    in_process = time.perf_counter() - t0
    want = capi_sessions.tsv(queries, hits).encode()
    require(rows == want and rows,
            "the demo's rows differ from SearchSession.search's")

    # full width through the shim in this process: the timed run
    lib = capi.load()
    require(lib.vstpu_api_init() == api.api_version(),
            "vstpu_api_init failed")
    times = []
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    results, _ = capi_sessions.search(lib, db_path, queries, times=times)
    session_s = time.perf_counter() - t0
    launches = dict(cuda_lib.LAUNCHES)
    check_launches(launches, "full width")
    require(capi_sessions.tsv(queries, results).encode() == rows,
            "the shim's hits differ from the demo's rows (full width)")
    first = times[0]
    times.sort()
    search_s = sum(times)
    emit({"phase": "capi_full", "queries": len(queries), "db": DB_SIZE,
          "seq_len": SEQ_LEN, "rows": rows.count(b"\n"),
          "demo_wall_s": wall, "session_s": session_s, "search_s": search_s,
          "queries_per_s": len(queries) / search_s,
          "call_ms_median": 1e3 * times[len(times) // 2],
          "call_ms_p99": 1e3 * times[min(len(times) - 1,
                                         int(0.99 * len(times)))],
          "call_ms_first": 1e3 * first, "call_ms_max": 1e3 * times[-1],
          "launches": launches, "in_process_s": in_process, "card": gpu})

    # the parity workload: cuda against cpu, and two threads (the cpu
    # run and the two-thread embedder at once: neither is timed)
    pdb, pq = write_parity_workload(d)
    cuda_rows, cuda_s = run(demo, pdb, pq)
    cpu_run = start(demo, pdb, pq, VSEARCH_TPU_TORCH_DEVICE="cpu")
    thread_rows, _ = run(threads_exe, pdb, pq)
    cpu_rows, both_s = finish(cpu_run)
    require(cuda_rows == cpu_rows and cuda_rows,
            "the demo's cuda and cpu rows differ")
    require(thread_rows == cuda_rows,
            "the two-thread embedder's rows differ from the demo's")
    emit({"phase": "capi_parity", "rows": cuda_rows.count(b"\n"),
          "equal": True, "cuda_s": cuda_s, "cpu_and_two_threads_s": both_s,
          "card": gpu})

    # the shim in this process on the parity workload, from this thread
    # and from a new one
    precs = read_fasta(pq)
    by_thread = {}
    for who in ("this_thread", "new_thread"):
        box = {}

        def drive():
            box["results"], box["nested"] = capi_sessions.search(
                lib, pdb, precs, nested=True)

        cuda_lib.reset_launches()
        if who == "this_thread":
            drive()
        else:
            th = threading.Thread(target=drive)
            th.start()
            th.join()
        require("results" in box, "the shim's session failed (%s)" % who)
        check_launches(dict(cuda_lib.LAUNCHES), who)
        require(box["nested"] == -1,
                "a nested vstpu_session_begin returned %s" % box["nested"])
        require(capi_sessions.tsv(precs, box["results"]).encode()
                == cuda_rows, "the shim's hits differ from the demo's "
                "rows (%s)" % who)
        by_thread[who] = dict(cuda_lib.LAUNCHES)
    lib.vstpu_api_finalize()
    emit({"phase": "capi_launches", "launches": by_thread["this_thread"],
          "new_thread_launches": by_thread["new_thread"], "card": gpu})
    return launches


def trace(run, match=()) -> dict:
    """run() once under torch.profiler: its wall seconds, the device's busy
    time, its idle share, the device time of the top kernels by name and
    (device_ms_matching) the device time of every kernel whose name holds
    one of the strings of match."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        seconds = run()
    # the program's spans (utils/phasetimer, "vs.*") show on the device's
    # timeline too, as annotations spanning work and gaps alike
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not (getattr(e, "is_user_annotation", False)
                            or e.name.startswith("vs.")))
    busy_us, end_us, by_name = 0.0, float("-inf"), {}
    for start, stop, name in spans:
        busy_us += max(0.0, stop - max(start, end_us))
        end_us = max(end_us, stop)
        name = name.split("(")[0]
        by_name[name] = by_name.get(name, 0.0) + (stop - start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"seconds": seconds, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e6 / seconds,
            "device_ms_by_name": dict(top),
            "device_ms_matching": {m: sum(ms for name, ms in by_name.items()
                                          if m in name) for m in match}}


def phase_full(gpu, db_path, q_path, extra=(), tag="full"):
    """The search cell: one warm-up, one timed run with the launch counts
    read around it, one traced run.  extra=MISMATCH_200 (tag "full_mm200")
    is the same cell on the codes wire: K1, K6 and K7, no K2 or K3."""
    import torch
    from vsearch_tpu_torch import cli
    from vsearch_tpu_torch.ops import cuda_lib
    codes = bool(extra)
    kernels = SEARCH_200_KERNELS if codes else SEARCH_KERNELS

    argv = ["--usearch_global", str(q_path), "--db", str(db_path), "--uc",
            os.devnull] + FULL_ARGS + list(extra)

    def run(qfile, uc):
        fresh_router(argv)
        t0 = time.perf_counter()
        rc = cli.main(["--usearch_global", str(qfile), "--db", str(db_path),
                       "--uc", str(uc)] + FULL_ARGS + list(extra),
                      device="cuda")
        torch.cuda.synchronize()
        require(rc == 0, "usearch_global failed")
        return time.perf_counter() - t0

    start_crossover = fresh_router(argv)
    # the warm-up fills the caching allocators (device and pinned host)
    run(q_path, WORK / ("%s_warm.uc" % tag))
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    with walk_round_k2() as walk:
        elapsed = run(q_path, WORK / ("%s.uc" % tag))
    launches = dict(cuda_lib.LAUNCHES)
    require(not any(cuda_lib.PLAIN_CALLS.values()),
            "a plain version ran on the main path")
    for name in kernels:
        require(launches[name] > 0,
                "kernel %s was not launched on the search path" % name)
    require_wire(launches, codes, tag)
    end_crossover = crossover(argv)
    lines = (WORK / ("%s.uc" % tag)).read_bytes().splitlines()
    require(len(lines) == N_QUERIES, "uc has %d lines" % len(lines))
    hits = sum(1 for ln in lines if ln.startswith(b"H\t"))
    emit({"phase": tag, "options": list(extra), "queries": N_QUERIES,
          "db": DB_SIZE,
          "seq_len": SEQ_LEN, "seconds": elapsed,
          "queries_per_s": N_QUERIES / elapsed, "hits": hits,
          "launches": launches, "chunks": -(-N_QUERIES // 512),
          "crossover_cells_start": start_crossover,
          "crossover_cells_end": end_crossover,
          "nw_rowscan_walk_rounds": walk.count,
          "nw_wavefront_walk_rounds": walk.count_k6,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "card": gpu})

    # the same run once more under the profiler: device time by kernel,
    # the share of the run's wall time in which the device was idle, and
    # the host's time by pipeline phase (utils/phasetimer)
    from vsearch_tpu_torch.utils import phasetimer
    phasetimer.ENABLED = True
    phasetimer.reset()
    traced = trace(lambda: run(q_path, WORK / ("%s_traced.uc" % tag)))
    phasetimer.ENABLED = False
    emit(dict({"phase": tag + "_traced"}, **traced,
              host_phase_s=dict(phasetimer.acc), card=gpu))
    return launches


def phase_cluster_full(gpu, amp_path):
    """The clustering cell: amp100k through --cluster_size --id 0.97
    --sizein --sizeout with the production DEVICE_MIN, timed once (the
    kernels are built and loaded by the earlier phases), the launches read
    around it; then the same run under torch.profiler.  Both print the
    host's time by pipeline phase."""
    import torch
    from vsearch_tpu_torch import cli
    from vsearch_tpu_torch.ops import cuda_lib
    n_seqs = 4 * AMP_FAMILIES
    argv = ["--cluster_size", str(amp_path)] + CLUSTER_ARGS

    def run(tag):
        fresh_router(argv)
        t0 = time.perf_counter()
        rc = cli.main(["--cluster_size", str(amp_path), "--uc",
                       str(WORK / ("%s.uc" % tag)), "--centroids",
                       str(WORK / ("%s.fa" % tag))] + CLUSTER_ARGS,
                      device="cuda")
        torch.cuda.synchronize()
        require(rc == 0, "cluster_size failed")
        return time.perf_counter() - t0

    start_crossover = fresh_router(argv)
    # host time by pipeline phase (utils/phasetimer: a clock read per span)
    from vsearch_tpu_torch.utils import phasetimer
    phasetimer.ENABLED = True
    torch.cuda.reset_peak_memory_stats()
    phasetimer.reset()
    cuda_lib.reset_launches()
    with walk_round_k2() as walk:
        elapsed = run("cluster")
    launches = dict(cuda_lib.LAUNCHES)
    host_phase_s = dict(phasetimer.acc)
    end_crossover = crossover(argv)
    require(not any(cuda_lib.PLAIN_CALLS.values()),
            "a plain version ran on the cluster path")
    for name in CLUSTER_KERNELS:
        require(launches[name] > 0,
                "kernel %s was not launched on the cluster path" % name)
    require_wire(launches, False, "cluster_full")
    lines = (WORK / "cluster.uc").read_bytes().splitlines()
    members = sum(1 for ln in lines if ln[:2] in (b"S\t", b"H\t"))
    clusters = sum(1 for ln in lines if ln.startswith(b"S\t"))
    require(members == n_seqs, "uc has %d S/H lines" % members)
    require(sum(1 for ln in lines if ln.startswith(b"C\t")) == clusters,
            "uc C lines do not count the clusters")
    require((WORK / "cluster.fa").read_bytes().count(b">") == clusters,
            "centroids do not count the clusters")
    emit({"phase": "cluster_full", "sequences": n_seqs,
          "seq_len": AMP_LEN, "seconds": elapsed,
          "sequences_per_s": n_seqs / elapsed, "clusters": clusters,
          "launches": launches,
          "device_rounds": launches["score_ranked"],
          "nw_rowscan_walk_rounds": walk.count,
          "nw_rowscan_prefetch": launches["nw_rowscan"] - walk.count,
          "crossover_cells_start": start_crossover,
          "crossover_cells_end": end_crossover,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "host_phase_s": host_phase_s, "card": gpu})
    phasetimer.reset()
    k4_name = "score_kernel<2>"              # EPI_RANK_KEY
    # K3 and the int16 fills that zero its ops (nw_batch.backtrack_rle)
    k3_names = ("nw_backtrack_kernel", "FillFunctor<short>")
    with ranked_words() as scanned:
        traced = trace(lambda: run("cluster_traced"),
                       match=("nw_rowscan", k4_name) + k3_names)
    phasetimer.ENABLED = False
    k2 = traced["device_ms_matching"]["nw_rowscan"]
    k4 = traced["device_ms_matching"][k4_name]
    emit(dict({"phase": "cluster_full_traced"}, **traced,
              nw_rowscan_share=k2 / 1e3 / traced["seconds"],
              nw_backtrack_ms=sum(traced["device_ms_matching"][m]
                                  for m in k3_names),
              score_ranked_ms=k4, score_ranked_launches=scanned.launches,
              score_ranked_ms_per_launch=k4 / max(1, scanned.launches),
              score_ranked_mean_words=scanned.words
              / max(1, scanned.launches),
              host_phase_s=dict(phasetimer.acc), card=gpu))
    return launches


def phase_allpairs_full(gpu, ap_path):
    """The allpairs cell: tools/bench_scale.py's allpairs_2000 shape
    through --allpairs_global --id 0.5 --blast6out, timed in turns as
    routed (K2m's 16-bit body, once a batch), through K2m's 32-bit body
    (its private body argument, as phase 2 takes it), and as routed again,
    with the launches and the pipeline's pair and batch counts read around
    each: every blast6 byte-equal.  Then its first AP_CPU_SEQS sequences on cuda and on cpu,
    byte-equal; then the cell as routed under torch.profiler with the host
    phase timer on."""
    import torch
    from vsearch_tpu_torch import cli
    from vsearch_tpu_torch.ops import cuda_lib, nw_rowscan
    from vsearch_tpu_torch.utils import phasetimer
    n_pairs = AP_SEQS * (AP_SEQS - 1) // 2
    argv = ["--allpairs_global", str(ap_path)] + AP_ARGS

    def run(tag, path=ap_path, device="cuda"):
        fresh_router(argv)
        t0 = time.perf_counter()
        rc = cli.main(["--allpairs_global", str(path), "--blast6out",
                       str(WORK / ("%s.b6" % tag))] + AP_ARGS,
                      device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        require(rc == 0, "allpairs_global failed")
        return time.perf_counter() - t0

    start_crossover = fresh_router(argv)
    forward = nw_rowscan._forward
    walls = {}
    for tag, body in (("allpairs", "nw_rowscan_mr16"),
                      ("allpairs_32bit", "nw_rowscan_mr"),
                      ("allpairs_again", "nw_rowscan_mr16")):
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launches()
        if body == "nw_rowscan_mr":
            # K2m's private body argument, as phase 2 takes it (K2's
            # calls, without the raw codes, do not read it)
            nw_rowscan._forward = functools.partial(forward, _body=body)
        try:
            with allpairs_counts() as counts, walk_round_k2() as walk:
                elapsed = run(tag)
        finally:
            nw_rowscan._forward = forward
        launches = dict(cuda_lib.LAUNCHES)
        walls[body] = walls.get(body, []) + [elapsed]
        batches = counts.batches
        require(not any(cuda_lib.PLAIN_CALLS.values()),
                "a plain version ran on the allpairs path")
        require(batches > 0 and launches[body] == batches
                and launches["nw_stats"] == batches
                and sum(launches[k] for k in K2M_BODIES) == batches,
                "K2m launched %s, K5 %d times for %d batches (%s)"
                % ({k: launches[k] for k in K2M_BODIES},
                   launches["nw_stats"], batches, tag))
        require_wire(launches, False, "allpairs_full")
        require(counts.pairs == n_pairs, "the pipeline saw %d pairs"
                % counts.pairs)
        lines = (WORK / ("%s.b6" % tag)).read_bytes().splitlines()
        require(len(lines) == counts.accepted,
                "blast6 has %d lines for %d accepted pairs"
                % (len(lines), counts.accepted))
        for ln in lines:
            q, t = ln.split(b"\t")[:2]
            require(int(q[1:]) < int(t[1:]),
                    "blast6 line with query >= target")
        if tag != "allpairs":
            require((WORK / ("%s.b6" % tag)).read_bytes()
                    == (WORK / "allpairs.b6").read_bytes(),
                    "the %s blast6 differs from the routed run's" % tag)
        emit({"phase": "allpairs_full", "run": tag, "k2m_body": body,
              "sequences": AP_SEQS, "seq_len": AP_LEN, "seconds": elapsed,
              "pairs_per_s": n_pairs / elapsed, "blast6_lines": len(lines),
              **counts.record(), "launches": launches,
              "nw_rowscan_walk_rounds": walk.count,
              "crossover_cells_start": start_crossover,
              "crossover_cells_end": crossover(argv),
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "card": gpu})
        if tag == "allpairs":
            routed = launches

    # the cell's first sequences on cuda and on cpu (the plain versions)
    head = WORK / "ap_head.fasta"
    head.write_bytes(b"".join(ap_path.read_bytes().splitlines(True)
                              [:2 * AP_CPU_SEQS]))
    cuda_lib.reset_launches()
    cuda_s = run("ap_head_cuda", head)
    head_launches = dict(cuda_lib.LAUNCHES)
    cpu_s = run("ap_head_cpu", head, "cpu")
    require(head_launches["nw_rowscan_mr16"] > 0,
            "K2m's 16-bit body did not run on the cell's first sequences")
    require((WORK / "ap_head_cuda.b6").read_bytes()
            == (WORK / "ap_head_cpu.b6").read_bytes(),
            "cuda and cpu blast6 differ on the cell's first sequences")
    emit({"phase": "allpairs_full_cpu_parity", "sequences": AP_CPU_SEQS,
          "equal": True, "cuda_seconds": cuda_s, "cpu_seconds": cpu_s,
          "launches": head_launches, "card": gpu})

    phasetimer.ENABLED = True
    phasetimer.reset()
    traced = trace(lambda: run("allpairs_traced"),
                   ("nw_rowscan_mr16_kernel", "nw_rowscan_kernel<true",
                    "nw_stats"))
    phasetimer.ENABLED = False
    k2m = traced["device_ms_matching"]["nw_rowscan_mr16_kernel"]
    emit(dict({"phase": "allpairs_full_traced"}, **traced,
              walls=walls, k2m_body="nw_rowscan_mr16", k2m_ms=k2m,
              nw_rowscan_mr_share=k2m / 1e3 / traced["seconds"],
              nw_rowscan_mr_ms_per_launch=k2m / routed["nw_rowscan_mr16"],
              nw_stats_ms=traced["device_ms_matching"]["nw_stats"],
              host_phase_s=dict(phasetimer.acc), card=gpu))
    return routed


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from vsearch_tpu_torch.ops import cuda_lib  # noqa: F401 (package check)
    from vsearch_tpu_torch.ops.nw_batch import BatchAligner
    global ROUTER_START
    ROUTER_START = (BatchAligner._dev_overhead_ema,
                    BatchAligner._native_rate_ema)
    t_start = time.perf_counter()
    gpu = card()
    WORK.mkdir(parents=True, exist_ok=True)
    phase_build(gpu)
    t0 = time.perf_counter()
    db_path, q_path = generate(WORK)
    amp_path = generate_amp(WORK / "amp100k.fasta")
    ap_path = generate_ap(WORK / "ap2000.fasta")
    chim_path = generate_amp(WORK / "amp50k.fasta", families=CHIM_FAMILIES)
    emit({"phase": "data", "seconds": time.perf_counter() - t0,
          "card": gpu})
    kern = phase_kernels(gpu, db_path, q_path)
    kern.update(phase_cluster_kernels(gpu, amp_path))
    kern.update(phase_allpairs_kernels(gpu, ap_path))
    phase_parity(gpu)
    phase_cluster_parity(gpu)
    match_220 = phase_allpairs_parity(gpu)
    mismatch_100, records = phase_overflow_parity(gpu)
    kern.update({o["kernel"]: o for o in records})
    phase_chimera_parity(gpu)
    phase_api_parity(gpu)
    phase_pipeline_parity(gpu)
    mb_db, mb_q, mb_uc, mb_b6 = phase_multiblock_parity(gpu)
    by_path = {"usearch_global": phase_full(gpu, db_path, q_path)}
    by_path["api_search"] = phase_api_full(gpu, db_path, q_path)
    by_path["capi_search"] = phase_capi(gpu, db_path, q_path)
    by_path["usearch_global_mismatch_200"] = phase_full(
        gpu, db_path, q_path, MISMATCH_200, "full_mm200")
    by_path["cluster_size"] = phase_cluster_full(gpu, amp_path)
    by_path["allpairs_global"] = phase_allpairs_full(gpu, ap_path)
    # phase 3's --match 220 allpairs run, the path of K2m's 32-bit body
    by_path["allpairs_global_match_220"] = match_220
    # phase 3's --match 1 --mismatch 100 runs, where pairs overflow
    by_path.update(mismatch_100)
    by_path["uchime3_denovo"], records = phase_chimera_full(gpu, chim_path)
    kern.update({o["kernel"]: o for o in records})
    by_path.update(phase_sharded(gpu, sharded_runs(
        db_path, q_path, amp_path, chim_path, mb_db, mb_q, mb_uc, mb_b6)))
    # each rank's shard of the multi-block DB holds two blocks: C =
    # 135 168 positions (MB_DB / 2 rounded up to 4096), one chunk of queries
    require(by_path["sharded_multiblock"]["score_dense"]
            == 2 * SHARDED_RANKS,
            "K1 launched %d times on the ranks' two blocks each"
            % by_path["sharded_multiblock"]["score_dense"])
    sources = {
        "score_dense": ("vsearch_tpu_torch/csrc/score_dense.cu",
                        "vsearch_tpu/ops/score_mxu.py:130"),
        "score_ranked": ("vsearch_tpu_torch/csrc/score_dense.cu",
                         "vsearch_tpu/ops/score_mxu.py:266"),
        "nw_rowscan": ("vsearch_tpu_torch/csrc/nw_rowscan.cu",
                       "vsearch_tpu/ops/nw_pallas2.py:387"),
        "nw_rowscan_mr16": ("vsearch_tpu_torch/csrc/nw_rowscan.cu",
                            "vsearch_tpu/ops/nw_pallas2.py:387"),
        "nw_rowscan_mr": ("vsearch_tpu_torch/csrc/nw_rowscan.cu",
                          "vsearch_tpu/ops/nw_pallas2.py:387"),
        "nw_backtrack": ("vsearch_tpu_torch/csrc/nw_backtrack.cu",
                         "vsearch_tpu/ops/nw_jax.py:320"),
        "nw_stats": ("vsearch_tpu_torch/csrc/nw_stats.cu",
                     "vsearch_tpu/ops/allpairs_dev.py:80"),
        "nw_wavefront": ("vsearch_tpu_torch/csrc/nw_wavefront.cu",
                         "vsearch_tpu/ops/nw_pallas.py:208"),
        "nw_backtrack_flat": ("vsearch_tpu_torch/csrc/nw_backtrack.cu",
                              "vsearch_tpu/ops/nw_jax.py:266"),
    }
    fields = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms")
    # the walks (K3, K5, K7): their times right after the forward that
    # writes their planes, their entries (K7: moves) a lane, and K7's
    # windows a lane as its counted build fetched them
    walk_fields = ("ms_after_k2", "ms_after_k2m", "ms_after_k6", "max_steps",
                   "mean_steps", "windows_max", "windows_mean")
    line = []
    for name, (src, rep) in sources.items():
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": rep,
                 "launches": sum(n[name] for n in by_path.values()),
                 "launches_by_path": {p: n[name]
                                      for p, n in by_path.items()}}
        entry.update({f: kern[name][f] for f in fields + walk_fields
                      if f in kern[name]})
        # K2, K3, K6 and K7 run at more than one shape: their numbers above
        # are at the search prefetch's, these at the cluster prefetch's, a
        # walk round's and the chimera cell's largest wave; K4's above at
        # the index's full capacity, its prefix shape at the filled blocks
        # the cell's top-k scans
        for shape in ("cluster", "walk", "prefix", "chimera", "single",
                      "overflow"):
            if name + "_" + shape in kern:
                other = kern[name + "_" + shape]
                entry[shape + "_shape"] = {f: other[f]
                                           for f in fields + walk_fields
                                           if f in other}
                entry["max_abs_err"] = max(entry["max_abs_err"],
                                           other["max_abs_err"])
        line.append(entry)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start,
          "card": gpu})
    emit({"kernels": line})
    print(gpu)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
