"""Every config, cell, entry and metric is a file found by name;
BENCHMARK.json keeps to its format and limits; the import check compares whole
top-level names."""

import json
import pathlib
import re
import shutil

import pytest

from benchmark.harness import importcheck, loader

from .tiny import TINY, run_cell

SPEC = loader.benchmark_json()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_spec_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = ([c["name"] for c in SPEC["configs"]]
             + [w["name"] for w in SPEC["workloads"]]
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    for w in SPEC["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)


@pytest.mark.parametrize("name", loader.configs())
def test_config_loads_and_agrees_with_its_argv(name):
    cfg = loader.config(name)
    assert len(cfg["source"]) <= 200
    assert loader.entry(cfg["entry"]).Entry
    argv = cfg["argv"]
    ref = cfg["reference"]
    opt = dict(zip(argv[::1], argv[1:]))
    assert float(opt["--id"]) == ref["id"]
    for key in ("maxaccepts", "maxrejects", "wordlength", "minwordmatches"):
        if key in ref:
            assert int(opt["--" + key]) == ref[key]
    s = ref["scheme"]
    assert int(opt["--match"]) == s["match"]
    assert int(opt["--mismatch"]) == s["mismatch"]
    assert opt["--gapopen"] == "%dI/%dE" % (s["open_int"], s["open_end"])
    assert opt["--gapext"] == "%dI/%dE" % (s["ext_int"], s["ext_end"])
    spec_cfg = {c["name"]: c for c in SPEC["configs"]}
    if name in spec_cfg:
        assert spec_cfg[name]["file"] == "benchmark/configs/%s.json" % name
        assert spec_cfg[name]["source"] == cfg["source"]
        assert spec_cfg[name]["reduced"] == cfg["reduced"]


@pytest.mark.parametrize("name", loader.cells())
def test_cell_loads(name):
    cell = loader.cell(name)
    assert cell["config"] in loader.configs()
    w = {x["name"]: x for x in SPEC["workloads"]}.get(name)
    if w is not None:
        assert w["config"] == cell["config"] and w["why"] == cell["why"]
        assert loader.end_to_end(name)["setup_s"]
        assert loader.per_layer(name)


@pytest.mark.parametrize("name", [m["name"] for m in SPEC["per_layer"]])
def test_metric_reader_found(name):
    assert callable(loader.metric(name).read)


def test_every_workload_has_its_files():
    for w in SPEC["workloads"]:
        assert w["name"] in loader.cells()
        rate = loader.config(w["config"])["rate_metric"]
        assert rate in loader.end_to_end(w["name"])


def test_new_cell_file_found_without_edit(tmp_path, monkeypatch, capsys):
    """A cell file added to a copy of the benchmark runs by its name."""
    copy = tmp_path / "benchmark"
    shutil.copytree(loader.BENCH_DIR, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (copy / "cells" / "allpairs_v34.tiny2.json").write_text(json.dumps(
        {"config": "allpairs_v34", "traffic": {"pool": 1},
         "why": "a cell no file of the harness names"}))
    monkeypatch.setattr(loader, "BENCH_DIR", copy)
    assert "allpairs_v34.tiny2" in loader.cells()
    over = {"config": TINY["allpairs_v34.related"]["config"]}
    rc, res = run_cell(capsys, "allpairs_v34.tiny2", 7, overrides=over)
    assert rc == 0 and res["correct"]
    # its rate is reported only where BENCHMARK.json lists the cell
    assert list(res["metrics"]) == ["setup_s"]


def test_import_check_compares_whole_top_level_names():
    assert importcheck.forbidden(["jax", "jax.numpy", "jaxlib.xla_client",
                                  "flax.linen", "vsearch_tpu",
                                  "vsearch_tpu.ops.nw"]) == [
        "flax", "jax", "jaxlib", "vsearch_tpu"]
    assert importcheck.forbidden(["vsearch_tpu_torch", "vsearch_tpu_torch.cli",
                                  "jaxtyping", "numpy", "benchmark.run"]) == []


def test_harness_imports_nothing_forbidden():
    """No source under benchmark/ imports jax, the JAX package,
    chip_smoke, bench*.py or tools/."""
    bad = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|vsearch_tpu|"
                     r"chip_smoke|bench(_\w+)?|tools)(\s|\.|$)", re.M)
    for path in pathlib.Path(loader.BENCH_DIR).rglob("*.py"):
        assert not bad.search(path.read_text()), path
