"""Run one cell of the benchmark of the PyTorch/CUDA port once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. With --trace 0 the last line of standard output
is the result with the cell's end-to-end metrics; with --trace 1 a short
traced window gives its per-layer metrics and a breakdown instead. Either
way the run ends by judging what the window produced against the plain
reference (`correct`), and prints each number compared beside its limit,
last on standard error and last in the result. Exit codes: 0 with a
result; 2 without a card, the program or the cell; 3 if the JAX stack or
the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".portbench_cache"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(cell, seed: int, seconds: float, trace: bool, dev, clock) -> dict:
    """Set-up, window, per-layer readers and the check of one cell on `dev`
    (no look for a card: run.main makes it). Returns the result's fields."""
    import torch

    from portbench import harness as H
    from portbench.trace import Tracer

    mod = H.kind_module(cell.traffic["kind"])
    run = mod.Run(cell, seed, dev, clock)
    tracer = Tracer(mod.SPAN) if trace else None
    out = run.execute(seconds, tracer)
    setup_s = clock.total()
    say(clock.line())
    cuda = dev.type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": cell.chips,
              "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev)) if cuda else 0}
    result = {"metrics": {}}
    if tracer is None:
        values = dict(out["e2e"], setup_s=setup_s)
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        data = out["trace"]
        if not data.complete:
            say(f"the traces held fewer kernels than the host launched ({data.launches}): "
                f"the per-layer numbers may read low")
        ctx = ReadContext(cell, data, out["work"])
        for m in cell.per_layer:
            value = H.metric_reader(m["name"]).read(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        device.update(busy_s=data.busy_s, window_s=data.window_s)
        result["breakdown"] = {"device_ops": data.device_ops(), "idle_gaps": data.idle_gaps()}
    result["device"] = device
    # the check, after the window and the memory reading, with the
    # program's state freed
    got = run.readings()
    run.free_program()
    want = run.reference("fp32")
    values = run.compare(got, want)
    limits = cell.traffic["limits"]
    checks = {k: {"value": _number(values[k]), "limit": limits[k]} for k in sorted(values)}
    ok = all(math.isfinite(values[k]) and values[k] <= limits[k] for k in values)
    result.update(correct=bool(ok and run.failed == 0 and run.attempted > 0),
                  attempted=run.attempted, failed=run.failed, checks=checks)
    return result


def _number(v: float) -> float:
    """JSON has no infinity or NaN: a comparison that found no number reads
    as the largest float."""
    return v if math.isfinite(v) else sys.float_info.max


class ReadContext:
    """What a per-layer metric's reader reads: the cell's configuration and
    traffic, the traced window and the work done in it."""

    def __init__(self, cell, trace, work: dict):
        from portbench import harness as H
        from portbench import yardstick

        self.cfg, self.traffic, self.trace, self.work = cell.config, cell.traffic, trace, work
        self.yardstick = yardstick
        self.kernel_names = H.kernel_names

    def kernel_seconds(self, family: str) -> float:
        names = self.kernel_names(family)
        return self.trace.device_seconds(names) if names else 0.0


def open_card():
    """The first card, its CUDA context made."""
    import torch

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.zeros(1, device=dev)
    return dev


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    from portbench import harness as H

    clock = H.SetupClock(T_START)
    try:
        cell = H.cell(args.workload)
    except H.BenchError as e:
        say(f"no result: {e}")
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        say(f"no result: {cell.name} needs {cell.chips} CUDA device(s), this machine has {n}")
        return 2
    try:
        import tpu_reid_torch  # noqa: F401
    except ImportError as e:
        say(f"no result: the program ({H.PROGRAM}) is not in {ROOT}: {e}")
        return 2
    clock.mark("imports")
    dev = open_card()
    clock.mark("cuda_context")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), dev, clock)
    bad = H.forbidden_loaded()
    if bad:
        say(f"no result: the process loaded {', '.join(bad)}")
        return 3
    line = {k: result[k] for k in ("correct", "attempted", "failed", "metrics", "device")}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = result["checks"]
    print(json.dumps(line), flush=True)
    for name, c in result["checks"].items():
        say(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # the checkout's root: the program and portbench as packages
    sys.exit(main())
