"""usearch_global end to end: the PyTorch port against the JAX package.

The port runs in a subprocess on its CPU device (VSEARCH_TPU_TORCH_DEVICE=
cpu: every kernel wrapper takes its plain version) so that its process can
be shown to load neither jax nor vsearch_tpu; the JAX package runs in
process.  Outputs must be byte-equal.
"""

import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

from .conftest import run_ours
from .test_device_search_parity import _write_workload

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "vsearch_tpu_torch"

# runs the port's CLI (after the setup lines), then reports what ran and
# what was imported
_DRIVER = """
import json, sys
from vsearch_tpu_torch import cli
from vsearch_tpu_torch.ops import cuda_lib
%s
rc = cli.main(sys.argv[1:])
print(json.dumps({"rc": rc, "launches": cuda_lib.LAUNCHES,
                  "plain_calls": cuda_lib.PLAIN_CALLS,
                  "modules": sorted(sys.modules)}))
"""


def run_port(args, cwd, device="cpu", setup=""):
    env = dict(os.environ)
    env["VSEARCH_TPU_TORCH_DEVICE"] = device
    # one intra-op thread: beside the other test workers on the same
    # cores, a thread team for each of the plain versions' small tensor
    # ops makes a run take minutes instead of seconds
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.run([sys.executable, "-c", _DRIVER % setup] + args,
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("extra", [
    ["--id", "0.8", "--maxaccepts", "1", "--maxrejects", "32"],
    ["--id", "0.9", "--maxaccepts", "4", "--maxrejects", "8",
     "--output_no_hits"],
    ["--id", "0.8", "--strand", "both"],
], ids=["ma1", "ma4_nohits", "both"])
def test_usearch_global_matches_jax(tmp_path, extra):
    db, q = _write_workload(tmp_path)
    args = ["--usearch_global", str(q), "--db", str(db)] + extra
    run_ours(args + ["--blast6out", "jax.b6", "--uc", "jax.uc"], tmp_path)
    rep = run_port(args + ["--blast6out", "port.b6", "--uc", "port.uc",
                           "--threads", "1", "--quiet"], tmp_path)
    assert rep["rc"] == 0
    assert (tmp_path / "jax.uc").read_bytes() == \
        (tmp_path / "port.uc").read_bytes()
    assert (tmp_path / "jax.b6").read_bytes() == \
        (tmp_path / "port.b6").read_bytes()
    assert (tmp_path / "port.uc").read_bytes().count(b"\n") == 64
    # the port's device tier ran (its plain versions, on the CPU device)
    assert all(rep["plain_calls"][k] > 0 for k in
               ("score_dense", "nw_rowscan", "nw_backtrack")), rep
    assert not any(rep["launches"].values())
    loaded = rep["modules"]
    assert "vsearch_tpu_torch.ops.score" in loaded
    assert not [m for m in loaded if m == "jax" or m.startswith("jax.")]
    assert not [m for m in loaded
                if m == "vsearch_tpu" or m.startswith("vsearch_tpu.")]


def test_entry_point_raises_without_card(monkeypatch, tmp_path):
    """Without a card and without an explicit CPU request the port raises
    instead of carrying on on the CPU."""
    import torch
    from vsearch_tpu_torch import cli, device
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv(device.ENV, raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.select()
    db, q = _write_workload(tmp_path, db_n=8, n_queries=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--usearch_global", str(q), "--db", str(db), "--id",
                  "0.9", "--uc", str(tmp_path / "x.uc"), "--quiet"])
    assert not (tmp_path / "x.uc").exists()


def test_unported_verb_fails(tmp_path):
    """Every verb of vsearch_tpu is ported, so an unknown command stands
    in: it fails, and writes nothing."""
    from vsearch_tpu_torch import cli
    db, _ = _write_workload(tmp_path, db_n=8, n_queries=1)
    rc = cli.main(["--no_such_command", str(db), "--output",
                   str(tmp_path / "o.fa"), "--quiet"], device="cpu")
    assert rc != 0
    assert not (tmp_path / "o.fa").exists()


def test_port_imports_neither_jax_nor_vsearch_tpu():
    bad = re.compile(r"^\s*(import|from)\s+(jax\b|vsearch_tpu\b(?!_torch))",
                     re.M)
    offenders = [str(p.relative_to(REPO)) for p in PORT.rglob("*.py")
                 if bad.search(p.read_text())]
    assert not offenders
    # K4 (score_ranked) shares K1's source, K2m (nw_rowscan_mr) K2's, K7
    # (nw_backtrack_flat) K3's
    from vsearch_tpu_torch.ops import cuda_lib
    assert sorted(p.name for p in (PORT / "csrc").glob("*.cu")) == [
        "nw_backtrack.cu", "nw_rowscan.cu", "nw_stats.cu",
        "nw_wavefront.cu", "score_dense.cu"]
    assert {s + ".cu" for s in cuda_lib.SOURCES.values()} == {
        "nw_backtrack.cu", "nw_rowscan.cu", "nw_stats.cu",
        "nw_wavefront.cu", "score_dense.cu"}
