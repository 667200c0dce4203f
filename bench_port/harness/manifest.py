"""The manifest (``BENCHMARK.json`` at the root of the checkout) and the
files it names, found by name under ``bench_port/``:

- ``workloads/<cell>.json``: the cell's configuration, option overrides,
  traffic (a closed loop: warm-up solves, solves traced in a traced run),
  the limits of its comparison with the reference, chips, why;
- ``configs/<config>.json``: the deployment (geometry maker and its
  parameters, options, the reference module), source, reduced, assumed;
- ``geometry/<maker>.py``: ``make(params, rng)``, the inputs from a seed;
- ``metrics/<metric>.py``: ``read(run)``, one metric's reader;
- ``reference/<name>.py``: ``solve(inputs, options, device, control, port=)`` and
  ``numbers(port, ref)``, the plain reference and its comparison.

A cell, a configuration, a maker, a metric or a reference added as a file
(and, for cells and metrics, an entry of the manifest) is found without an
edit to any file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List

# the benchmark's folder and the checkout's root, read at each call (a test
# may point them at a copy)
BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    check_name(name)
    return load_json(BENCH_DIR / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    check_name(name)
    return load_json(BENCH_DIR / "configs" / f"{name}.json")


def check_name(name: str) -> str:
    if not NAME_RE.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _load_module(kind: str, name: str) -> ModuleType:
    """``bench_port/<kind>/<name>.py`` as a module of its own (a name may
    hold dots and dashes, so it is loaded by path, not imported)."""
    check_name(name)
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    mod_name = f"bench_{kind}_" + re.sub(r"[^A-Za-z0-9_]", "_", name)
    known = sys.modules.get(mod_name)
    if known is not None and Path(known.__file__) == path:
        return known
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_module(name: str) -> ModuleType:
    return _load_module("metrics", name)


def geometry_module(name: str) -> ModuleType:
    return _load_module("geometry", name)


def reference_module(name: str) -> ModuleType:
    """``reference/<name>.py``, imported as a module of the ``reference``
    package (the grid's imports the frozen host code beside it)."""
    import importlib

    check_name(name)
    return importlib.import_module(f"reference.{name}")


def cell_metrics(man: dict, cell: str, trace: bool) -> List[dict]:
    """The manifest's metrics that ``cell`` reports: its end-to-end metrics
    (``trace`` false) or its per-layer ones (``trace`` true); a metric
    with a ``workloads`` list is reported in those cells only."""
    group = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def cell_entry(man: dict, cell: str) -> Dict:
    for w in man["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"cell {cell!r} is not in BENCHMARK.json")
