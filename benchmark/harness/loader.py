"""Find the pieces of a cell by name.

``cells/<cell>.json`` names its config and holds the traffic;
``configs/<config>.json`` holds the deployment and names its entry;
``entries/<entry>.py`` drives one command of the program;
``metrics/<metric>.py`` reads one per-layer metric.  BENCHMARK.json, at
the root of the checkout, says which metrics a cell reports.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def _json(path: pathlib.Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def cell(name: str) -> dict:
    """The traffic of a cell, with its name."""
    path = BENCH_DIR / "cells" / ("%s.json" % name)
    if not path.is_file():
        raise KeyError("no cell %r (%s)" % (name, path))
    return dict(_json(path), name=name)


def config(name: str) -> dict:
    """A deployment, with its name."""
    path = BENCH_DIR / "configs" / ("%s.json" % name)
    if not path.is_file():
        raise KeyError("no config %r (%s)" % (name, path))
    return dict(_json(path), name=name)


def cells() -> List[str]:
    return sorted(p.stem for p in (BENCH_DIR / "cells").glob("*.json"))


def configs() -> List[str]:
    return sorted(p.stem for p in (BENCH_DIR / "configs").glob("*.json"))


def _module(kind: str, name: str) -> ModuleType:
    path = BENCH_DIR / kind / ("%s.py" % name)
    if not path.is_file():
        raise KeyError("no %s %r (%s)" % (kind, name, path))
    spec = importlib.util.spec_from_file_location(
        "benchmark_%s_%s" % (kind, name.replace(".", "_")), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(name: str) -> ModuleType:
    return _module("entries", name)


def metric(name: str) -> ModuleType:
    return _module("metrics", name)


def _merge(base: dict, extra: Optional[dict]) -> dict:
    out = dict(base)
    for k, v in (extra or {}).items():
        out[k] = (_merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


def resolve(workload: str, overrides: Optional[dict] = None):
    """(cell, config) of a workload; ``overrides`` ({"cell": ...,
    "config": ...}) merges into them (the tests' tiny sizes)."""
    overrides = overrides or {}
    c = _merge(cell(workload), overrides.get("cell"))
    return c, _merge(config(c["config"]), overrides.get("config"))


def benchmark_json() -> Optional[dict]:
    path = ROOT / "BENCHMARK.json"
    return _json(path) if path.is_file() else None


def _for_cell(entries: List[dict], cell_name: str) -> List[dict]:
    return [m for m in entries
            if "workloads" not in m or cell_name in m["workloads"]]


def end_to_end(cell_name: str, spec: Optional[dict] = None) -> Dict[str, dict]:
    """name -> entry of the end-to-end metrics the cell reports."""
    spec = spec if spec is not None else benchmark_json() or {}
    return {m["name"]: m for m in _for_cell(spec.get("end_to_end", []),
                                            cell_name)}


def per_layer(cell_name: str, spec: Optional[dict] = None) -> Dict[str, dict]:
    """name -> entry of the per-layer metrics the cell reports."""
    spec = spec if spec is not None else benchmark_json() or {}
    return {m["name"]: m for m in _for_cell(spec.get("per_layer", []),
                                            cell_name)}
