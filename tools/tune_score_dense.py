#!/usr/bin/env python3
"""Time variants of the K1/K4 kernel source against the shipped build.

    python3 tools/tune_score_dense.py

Needs one CUDA device and nvcc; imports nothing of jax.  Each variant is
vsearch_tpu_torch/csrc/score_dense.cu with one edit (VARIANTS below),
built by nvcc with the port's flags into the git-ignored
build/vsearch_tpu_torch/tune/.  The inputs are chip_smoke.py's: K4 on the
amp100k cell's growing index at its full capacity and on the filled
prefix its top-k scans, and K1 (packed key) on the search cell's first
512 queries against its index block.  Every variant's output must equal
the shipped kernel's (which chip_smoke.py phase 2 holds against the plain
version).  Each is timed twice, in the order shipped, variants, variants
reversed, shipped; the last line of the output is one JSON object with
the card, ptxas's register counts and the milliseconds.
"""

import ctypes
import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

# the grid order: queries fastest (blockIdx.x), then word tiles
GRID = ("const int q = blockIdx.x;\n"
        "    const int w0 = blockIdx.y * THREADS;",
        "return dim3(qp, (words + THREADS - 1) / THREADS);")
# name -> (what it changes, [(old, new), ...])
VARIANTS = {
    "tile64": ("64-word tiles, 64 threads a block",
               [("#define THREADS 128", "#define THREADS 64")]),
    "tile256": ("256-word tiles, 256 threads a block",
                [("#define THREADS 128", "#define THREADS 256")]),
    "tiles_fastest": ("word tiles fastest in the grid, as the SWAR body had",
                      [(GRID[0], "const int q = blockIdx.y;\n"
                                 "    const int w0 = blockIdx.x * THREADS;"),
                       (GRID[1], "return dim3((words + THREADS - 1) / "
                                 "THREADS, qp);")]),
    "planes9": ("9 bit planes, windows of 496 ids",
                [("#define PLANES 12", "#define PLANES 9"),
                 ("#define ID_CAP 2048", "#define ID_CAP 496")]),
    "unroll1": ("the group loop not unrolled",
                [("#pragma unroll 2\n", "#pragma unroll 1\n")]),
}


def build_variants(src: str, out_dir: pathlib.Path) -> dict:
    """Compile every variant, all nvcc processes started together; returns
    {name: (ctypes library, ptxas register lines)}."""
    from vsearch_tpu_torch.ops import cuda_lib
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (_, edits) in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError("variant %s: %r not in the source"
                                   % (name, old))
            text = text.replace(old, new)
        cu = out_dir / (name + ".cu")
        cu.write_text(text)
        so = out_dir / ("lib%s.so" % name)
        procs[name] = (subprocess.Popen(
            [cuda_lib._nvcc()] + cuda_lib.NVCC_FLAGS + ["-o", str(so),
                                                        str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError("nvcc failed for %s:\n%s" % (name, log))
        libs[name] = (_bind(ctypes.CDLL(str(so))), _registers(log))
    return libs


def _registers(ptxas_log: str):
    """ptxas's distinct register lines (one per kernel instantiation)."""
    return sorted({ln.split(":", 1)[1].strip()
                   for ln in ptxas_log.splitlines() if "registers" in ln})


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.score_dense_launch.argtypes = [p, i, i, p, i, i, i, i, i, p, p]
    lib.score_ranked_launch.argtypes = [p, i, i, p, i, i, i, p, p, p]
    return lib


def compare(libs, make_call, reps=20) -> dict:
    """ms per launch of every library, timed in turns; every output must
    equal the shipped library's."""
    import torch
    ref = make_call(libs["shipped"])().clone()
    torch.cuda.synchronize()
    order = list(libs) + list(reversed(list(libs)))
    times = {}
    for name in order:
        call = make_call(libs[name])
        chip_smoke.require(torch.equal(call(), ref),
                           "variant %s differs from the shipped kernel"
                           % name)
        times.setdefault(name, []).append(chip_smoke.timed(call, reps))
    return times


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tune_score_dense: no CUDA device", file=sys.stderr)
        return 1
    from vsearch_tpu_torch import device
    from vsearch_tpu_torch.ops import cuda_lib, score_dense
    gpu = chip_smoke.card()
    shipped = cuda_lib.build(["score_dense"], force=True)["score_dense"]
    built = build_variants((cuda_lib.CSRC / "score_dense.cu").read_text(),
                           cuda_lib.BUILD_DIR / "tune")
    libs = {"shipped": score_dense._lib()}
    libs.update({name: lib for name, (lib, _) in built.items()})
    registers = {name: regs for name, (_, regs) in built.items()}
    registers["shipped"] = _registers(shipped["ptxas"])
    dev = device.select("cuda")
    stream = cuda_lib.stream_ptr(dev)
    chip_smoke.WORK.mkdir(parents=True, exist_ok=True)
    result = {"card": gpu, "registers": registers,
              "variants": {k: v[0] for k, v in VARIANTS.items()}}

    amp = chip_smoke.generate_amp(chip_smoke.WORK / "amp100k.fasta")
    _, g, _, klists, Kbits = chip_smoke.cluster_round(amp)
    rank = g._ranks()
    qp, V = len(klists), g.hashsize
    for tag, words in (("k4_full", g.words), ("k4_prefix", g.scan_words())):
        out = torch.empty((qp, words * 32), dtype=torch.int32, device=dev)

        def k4(lib, words=words, out=out):
            def call():
                cuda_lib.check(lib.score_ranked_launch(
                    Kbits.data_ptr(), qp, Kbits.shape[1], g.bits.data_ptr(),
                    V, words, g.words, rank.data_ptr(), out.data_ptr(),
                    stream), "score_ranked")
                return out
            return call
        result[tag] = {"words": words, "ms": compare(libs, k4)}
        print(json.dumps({tag: result[tag]}), flush=True)
    del g, Kbits, rank
    torch.cuda.empty_cache()

    db_path, q_path = chip_smoke.generate(chip_smoke.WORK)
    ctx, _, klists, Kbits = chip_smoke.search_chunk(db_path, q_path)
    bits, words, _, n_real = ctx.device_index.blocks[0]
    qp = len(klists)
    out = torch.empty((qp, words * 32), dtype=torch.int32, device=dev)

    def k1(lib):
        def call():
            cuda_lib.check(lib.score_dense_launch(
                Kbits.data_ptr(), qp, Kbits.shape[1], bits.data_ptr(),
                bits.shape[0], words, bits.stride(0), n_real, 1,
                out.data_ptr(), stream), "score_dense")
            return out
        return call
    result["k1"] = {"words": words, "ms": compare(libs, k1)}
    print(json.dumps({"k1": result["k1"]}), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
