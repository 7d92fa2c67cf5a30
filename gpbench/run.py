"""One run of one cell:

    python3 -m gpbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the inputs and the hyperparameters from the seed, builds the
port's kernels where the checkout has none built, makes the wrapper and
runs the mix's warm-up requests. The window then drives the wrapper in a
closed loop for ``--seconds``. Once it has closed, the peak device memory
is read, the program's outputs are kept and its state freed, and the
plain reference replays the run to decide ``correct``. The last line of
standard output is the result; the numbers compared, each beside its
limit, are the last lines of standard error.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from gpbench import check, counts, spec, trace
from gpbench.traffic import Record, Stream, check_mix, draw_hypers, drive, make_inputs, run_request, sync

FORBIDDEN = ("jax", "jaxlib", "flax", "online_gp_tpu")
CHECK_POINTS = 4096  # query points the state is judged at


class Context(NamedTuple):
    """What a metric's reader reads."""

    cell: spec.Cell
    record: Record
    first: int  # the first window request
    window_s: float
    setup_s: float
    trace: Optional[trace.Trace]
    peaks: Optional[tuple]  # (bytes/s, flop/s) of the card
    sizes: tuple  # grid points a dimension
    block: int  # points a chunk of K1
    outputs: int  # the state's outputs, K1's batch Bd


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def check_queries(config: Dict, mix: Dict, seed: int, device) -> torch.Tensor:
    rng = np.random.default_rng([seed, 3])
    s = mix["stream"]
    q = rng.uniform(s["low"], s["high"], size=(CHECK_POINTS, config["input_dim"]))
    return torch.as_tensor(q, dtype=torch.float64, device=device)


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, device, t_start: float,
             control: bool = False) -> Dict:
    """Run the cell once and return the result's fields (and, under
    ``numbers``, every number the check computed; ``control`` also judges
    the control on the same requests)."""
    config, mix = cell.config, cell.mix
    check_mix(mix)
    system = spec.wrapper(config)
    on_cuda = torch.device(device).type == "cuda"
    phases = [("start", time.perf_counter())]
    if on_cuda:
        system.build()
        torch.cuda.reset_peak_memory_stats(device)
    phases.append(("kernels", time.perf_counter()))
    inputs = make_inputs(mix, config["input_dim"], seed, device)
    hypers = draw_hypers(config, seed)
    phases.append(("inputs", time.perf_counter()))
    reg = system.make(config, hypers, inputs.seed_x, inputs.seed_y, device)
    sync(device)
    phases.append(("state", time.perf_counter()))
    record, stream = Record(), Stream(inputs)
    for _ in range(mix["warmup_requests"]):
        run_request(reg, mix, stream, record)
        sync(device)
    phases.append(("warmup", time.perf_counter()))
    first = len(record.requests)
    failed = 0

    def window():
        mark = trace.marker if traced else None
        return drive(reg, mix, stream, record, seconds, device, marker=mark)

    setup_s = time.perf_counter() - t_start
    try:
        if traced:
            prof, window_s = trace.profiled(window)
        else:
            window_s = window()
    except RuntimeError as exc:  # a request that raised: it failed, and the run is not correct
        print(f"a request raised: {exc!r}", file=sys.stderr)
        failed, window_s, traced = 1, float("nan"), False
    attempted = len(record.requests) - first + failed
    peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0
    fin = system.final(reg)
    del reg
    picked = check.sample_requests(record, first, mix["check_requests"], seed)
    got = check.program_produced(fin, record, picked)
    del fin
    if on_cuda:
        torch.cuda.empty_cache()

    tr = trace.reduce(prof, first, window_s) if traced else None
    if traced:
        del prof
    name = torch.cuda.get_device_name(device) if on_cuda else "cpu"
    peaks = counts.card_peaks(name)[1] if on_cuda else None
    ctx = Context(cell, record, first, window_s, setup_s, tr, peaks,
                  (config["wrapper"]["grid_size"],) * config["input_dim"], config["block_size"], config["num_outputs"])
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.reader(m["name"])(ctx) if failed == 0 else None
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    truth, A_eps, K = check.replay(config, hypers, inputs, record, picked, device)
    queries = check_queries(config, mix, seed, device)
    numbers = check.judge(got, truth, A_eps, K, config, hypers, queries, record)
    correct, shown = check.verdict(numbers, cell.limits)
    out = {"correct": bool(correct and failed == 0), "attempted": attempted, "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if on_cuda else "cpu", "kind": name, "count": 1,
                      "memory_peak_bytes": int(peak)}}
    if tr is not None:
        out["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
    out["checks"] = shown
    out["numbers"] = numbers
    out["setup_phases"] = {"before": phases[0][1] - t_start,
                           **{b[0]: b[1] - a[1] for a, b in zip(phases, phases[1:])}}
    if control:
        ctrl, _, _ = check.replay(config, hypers, inputs, record, picked, device, control=True)
        out["control"] = check.judge(ctrl, truth, A_eps, K, config, hypers, queries, record)
    return out


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m gpbench", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t_start: float = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has {have}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark may load neither JAX nor the JAX package", file=sys.stderr)
        return 3
    out.pop("numbers")
    print("set-up seconds: " + json.dumps(out.pop("setup_phases")), file=sys.stderr)
    checks = out.pop("checks")
    out["checks"] = checks  # last in the line
    for k, v in checks.items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
