"""A cell of BENCHMARK.json cut to a size a CPU test run holds: an 8 x 8
grid and a pool of 20,000 points. The steps, their sizes and their order
are the cell's own."""

import copy

from gpbench import spec

ROOT = spec.ROOT


CELLS = [w["name"] for w in spec.load_json(ROOT / "BENCHMARK.json")["workloads"]]


def small_cell(name: str, grid: int = 8):
    """The cell ``name`` cut to a CPU test's size."""
    cell = spec.load_cell(name)
    config = copy.deepcopy(cell.config)
    config["wrapper"]["grid_size"] = grid
    mix = copy.deepcopy(cell.mix)
    mix["pool_points"] = 20000
    mix["queries"] = min(mix["queries"], 256)
    return cell._replace(config=config, mix=mix)
