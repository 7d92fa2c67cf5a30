"""Find everything a cell needs by the names in ``BENCHMARK.json``:

  configs/<config>.json   the configuration (``file`` of its entry)
  wrappers/<factory>.py   the system under test that a configuration's
                          ``wrapper.factory`` names: ``build()``, ``make(...)``
                          and ``final(wrapper)``
  traffic/<traffic>.json  the traffic mix
  ops/<op>.py             each step of a mix's requests: ``run`` drives the
                          program, ``replay`` the reference (and ``flops``,
                          ``judge``)
  limits/<cell>.json      the numbers ``correct`` compares, with their limits
  metrics/<metric>.py     each metric's reader; a metric ``a.b`` without a file
                          of its own is read by ``metrics/a.py``
"""

from __future__ import annotations

import functools
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, NamedTuple

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


class Cell(NamedTuple):
    name: str
    chips: int
    config: Dict
    mix: Dict
    limits: Dict[str, Dict]
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Dict = None) -> Cell:
    bench = load_json(ROOT / "BENCHMARK.json") if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name,
        chips=w["chips"],
        config=load_json(ROOT / conf["file"]),
        mix=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(HERE / "limits" / f"{name}.json")["limits"],
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


@functools.lru_cache(maxsize=None)
def module(kind: str, name: str):
    """The module ``gpbench/<kind>/<name>.py``, loaded once."""
    path = HERE / kind / f"{name}.py"
    if not path.exists():
        raise KeyError(f"no {kind[:-1]} {name!r}: {path.relative_to(ROOT)} does not exist")
    mod_spec = importlib.util.spec_from_file_location(f"gpbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def op(name: str):
    """The module of a request step's ``op``."""
    return module("ops", name)


def wrapper(config: Dict):
    """The module that builds the system a configuration names."""
    return module("wrappers", config["wrapper"]["factory"])


def reader_path(metric: str) -> Path:
    own = HERE / "metrics" / f"{metric}.py"
    return own if own.exists() else HERE / "metrics" / f"{metric.split('.')[0]}.py"


def reader(metric: str):
    """The ``read(ctx)`` function of the metric's reader file."""
    return module("metrics", reader_path(metric).stem).read
