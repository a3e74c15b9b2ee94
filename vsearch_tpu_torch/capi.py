"""Build the C-ABI embedding shim: csrc/capi.c (the contract is
csrc/vsearch_tpu_torch_api.h) and its demo embedder csrc/capi_demo.c.

    from vsearch_tpu_torch import capi
    lib, demo = capi.build()
    subprocess.run([demo, "db.fasta", "queries.fasta", "0.9"],
                   env=capi.embed_env())

``cc`` compiles both at first use, against the shared libpython of the
interpreter that builds them, into the git-ignored
build/vsearch_tpu_torch/capi/, and again whenever a source is newer than
its output.  Each output is written under a private name and renamed, so
that concurrent processes (test workers) never load a half-written one.
The shim hosts its own interpreter, which finds torch and this package
through the PYTHONPATH that ``embed_env`` sets.  ``load`` loads the shim
into a running interpreter instead (it then starts none), its functions
typed and ``Hit`` laid out as vstpu_hit_t.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import sys
import sysconfig
import threading
from typing import Dict, Iterable, Optional, Tuple

from . import native

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
HEADER = CSRC / "vsearch_tpu_torch_api.h"
BUILD_DIR = native.BUILD_DIR / "capi"
LIB = BUILD_DIR / "libvsearch_tpu_torch_capi.so"
DEMO = BUILD_DIR / "capi_demo"

_lock = threading.Lock()


def _libpython() -> Tuple[str, str, str]:
    """(include dir, lib dir, library name) of the shared libpython;
    raises where the interpreter has none to link."""
    libdir = sysconfig.get_config_var("LIBDIR")
    name = "python" + sysconfig.get_config_var("LDVERSION")
    if not os.path.exists(os.path.join(libdir, "lib%s.so" % name)):
        raise RuntimeError(
            "no shared lib%s.so in %s: the C-ABI shim links the shared "
            "libpython" % (name, libdir))
    return sysconfig.get_paths()["include"], libdir, name


def _stale(out: pathlib.Path, deps: Iterable[pathlib.Path]) -> bool:
    return (not out.exists()
            or any(out.stat().st_mtime < d.stat().st_mtime for d in deps))


def _cc(args, out: pathlib.Path) -> None:
    """Run cc writing `out` under a private name, then rename it."""
    tmp = out.with_name("%s.%d" % (out.name, os.getpid()))
    proc = subprocess.run(["cc", "-O2"] + args + ["-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("cc failed for %s:\n%s" % (out.name, proc.stderr))
    os.replace(tmp, out)


def compile_embedder(source: pathlib.Path, out: pathlib.Path,
                     force: bool = False) -> pathlib.Path:
    """Compile a C program that includes vsearch_tpu_torch_api.h and
    links the shim (built first where missing or stale)."""
    lib = build_lib(force)
    with _lock:
        if force or _stale(out, (source, HEADER, lib)):
            _, libdir, name = _libpython()
            _cc(["-I", str(CSRC), str(source), "-L", str(BUILD_DIR),
                 "-lvsearch_tpu_torch_capi", "-L", libdir, "-l" + name,
                 "-lpthread", "-Wl,-rpath," + str(BUILD_DIR),
                 "-Wl,-rpath," + libdir], out)
    return out


def build_lib(force: bool = False) -> pathlib.Path:
    """The shim's shared library, built where missing or stale, or built
    against another interpreter's libpython (a copied build tree)."""
    with _lock:
        include, libdir, name = _libpython()
        stamp = BUILD_DIR / "libpython.txt"
        which = "%s/lib%s.so\n" % (libdir, name)
        if (force or _stale(LIB, (CSRC / "capi.c", HEADER))
                or not stamp.exists() or stamp.read_text() != which):
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            _cc(["-fPIC", "-shared", "-I", include, str(CSRC / "capi.c"),
                 "-L", libdir, "-l" + name, "-Wl,-rpath," + libdir], LIB)
            stamp.write_text(which)
    return LIB


def build(force: bool = False) -> Tuple[pathlib.Path, pathlib.Path]:
    """(library, demo): the shim and the demo embedder, built where
    missing or stale."""
    return LIB, compile_embedder(CSRC / "capi_demo.c", DEMO, force)


class Hit(ctypes.Structure):
    """vstpu_hit_t."""
    _fields_ = [("target", ctypes.c_long), ("id", ctypes.c_double),
                ("matches", ctypes.c_long), ("mismatches", ctypes.c_long),
                ("gaps", ctypes.c_long),
                ("alignment_length", ctypes.c_long),
                ("query_length", ctypes.c_long),
                ("target_length", ctypes.c_long), ("strand", ctypes.c_int),
                ("target_label", ctypes.c_char * 256),
                ("cigar", ctypes.c_char * 4096)]


def load() -> ctypes.CDLL:
    """The shim loaded into this process, built first where missing or
    stale.  Its calls give up the GIL (ctypes.CDLL), which the shim takes
    per call."""
    lib = ctypes.CDLL(str(build_lib()))
    p, i, s = ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p
    for name, res, args in (
            ("vstpu_api_init", i, []), ("vstpu_api_finalize", None, []),
            ("vstpu_params_new", p, []),
            ("vstpu_params_set_num", i, [p, s, ctypes.c_double]),
            ("vstpu_params_set_str", i, [p, s, s]),
            ("vstpu_params_free", None, [p]),
            ("vstpu_session_begin", i, [p]), ("vstpu_session_end", i, []),
            ("vstpu_search_open", p, [p, s]),
            ("vstpu_search_single", i,
             [p, s, s, ctypes.POINTER(Hit), i]),
            ("vstpu_search_close", None, [p]),
            ("vstpu_dust_single", i, [s, s, i])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def embed_env(env: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """`env` (default os.environ) with a PYTHONPATH under which an
    embedded interpreter imports this package and the running
    interpreter's packages, torch among them."""
    env = dict(os.environ if env is None else env)
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    paths = [repo] + [p for p in sys.path if p and p != repo]
    env["PYTHONPATH"] = os.pathsep.join(paths)
    return env
