"""BENCHMARK.json holds to the benchmark's contract, and the harness finds
every configuration, mix, limits file and metric reader by name."""

import json
import re

import pytest

from gpbench import spec

BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:3] == ["python3", "-m", "gpbench"]
    assert BENCH["paths"] == ["gpbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_keys():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[key]]
    assert all(NAME.match(n) for n in names)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        group = [x["name"] for x in BENCH[key]]
        assert len(group) == len(set(group)), key
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("gpbench/") and (spec.ROOT / c["file"]).exists()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert m["better"] in ("lower", "higher")
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert set(m["workloads"]) <= set(CELLS) if "workloads" in m else True
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}


def test_every_cell_reports_what_its_layers_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or cell in moved["workloads"], (m["name"], cell)
    for cell in CELLS:
        reported = [m for m in BENCH["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
        assert len(reported) >= 2
        assert any(cell in m.get("workloads", CELLS) for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = spec.load_cell(cell, BENCH)
    assert c.limits and all("limit" in v for v in c.limits.values())
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]))
    assert c.config["inducing_points"] == c.config["wrapper"]["grid_size"] ** c.config["input_dim"]
    system = spec.wrapper(c.config)
    assert all(callable(getattr(system, f)) for f in ("build", "make", "final"))
    for step in c.mix["request"]:
        op = spec.op(step["op"])
        assert all(callable(getattr(op, f)) for f in ("run", "replay", "flops"))


def test_an_unknown_op_or_factory_is_named():
    with pytest.raises(KeyError, match="ops/no_such_op.py"):
        spec.op("no_such_op")
    with pytest.raises(KeyError, match="wrappers/no_such.py"):
        spec.wrapper({"wrapper": {"factory": "no_such"}})


def test_reader_falls_back_to_the_stem():
    assert spec.reader_path("device_idle.absorb").name == "device_idle.py"
    assert spec.reader_path("setup_s").name == "setup_s.py"
