"""What every cell shares: the manifest and the files it names, the seeded
weights, the set-up clock, and the guard against the JAX package.

A cell is an entry of BENCHMARK.json's `workloads`. Everything of one
configuration, traffic mix, per-layer metric or kernel family is a file of
its own under portbench/, found by the name the manifest gives:

  configs/<config>.json        the sizes, as run; "reference" and "program"
                               name the plain reference and the program
                               binding beside it (configs/<name>.py)
  traffic/<traffic>.json       the mix's parameters; "kind" names the code
                               that runs it (kinds/<kind>.py)
  metrics/<metric>.py          a per-layer metric's reader: read(ctx) -> a
                               number, or None where it finds nothing
  kernels/<family>/*.txt       kernel names, one per line, that a roofline
                               or share divides by (a later kernel adds a file)
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# top-level module names that must not be loaded in a run: the JAX stack and
# the JAX package the port was made from (compared as whole names: the
# port's own name begins with the latter)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "tpu_reid")

PROGRAM = "tpu_reid_torch"


class BenchError(Exception):
    """A manifest or a file it names that the harness cannot use."""


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def load_module(path: Path, name: str):
    """The Python file at `path` as a module (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise BenchError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    if not path.is_file():
        raise BenchError(f"missing {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def manifest() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def config_file(man: dict, name: str) -> Path:
    for c in man["configs"]:
        if c["name"] == name:
            return ROOT / c["file"]
    raise BenchError(f"no configuration {name!r} in BENCHMARK.json")


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def cell(name: str, man: dict = None) -> Cell:
    """The workload `name` with its configuration, traffic and metrics."""
    man = man or manifest()
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")
    config = read_json(config_file(man, entry["config"]))
    traffic = read_json(HERE / "traffic" / f"{entry['traffic']}.json")
    e2e = [m for m in man["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"] if _applies(m, name, reported)]
    return Cell(name, config, traffic, int(entry["chips"]), e2e, per_layer)


def config_module(cfg: dict, role: str):
    """The configuration's plain reference (role "reference") or program
    binding (role "program"), from configs/<name>.py."""
    name = cfg[role]
    return load_module(HERE / "configs" / f"{name}.py", f"portbench_cfg_{name}")


def kind_module(kind: str):
    """The code that runs a traffic mix of this kind: kinds/<kind>.py."""
    return load_module(HERE / "kinds" / f"{kind}.py", f"portbench_kind_{kind}")


def metric_reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py", f"portbench_metric_{name}")


def kernel_names(family: str) -> List[str]:
    """The kernel names of a family: every line of kernels/<family>/*.txt."""
    names = []
    for path in sorted((HERE / "kernels" / family).glob("*.txt")):
        names += [ln.strip() for ln in path.read_text().splitlines()
                  if ln.strip() and not ln.startswith("#")]
    return names


def forbidden_loaded() -> List[str]:
    """The forbidden top-level modules this process has loaded."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


class SetupClock:
    """Seconds of each part of the set-up, from the process's start."""

    def __init__(self, t0: float):
        self.t0 = self.last = t0
        self.parts: Dict[str, float] = {}

    def mark(self, part: str) -> None:
        now = time.perf_counter()
        self.parts[part] = self.parts.get(part, 0.0) + now - self.last
        self.last = now

    def total(self) -> float:
        return self.last - self.t0

    def line(self) -> str:
        parts = ", ".join(f"{k} {v:.3f}" for k, v in self.parts.items())
        return f"setup: {parts} (s; total {self.total():.3f})"


def make_raw(spec: list, seed: int, device, dtype) -> dict:
    """The raw weights {name: tensor} of a parameter spec
    [(name, shape, std, mean)], drawn on `device` from `seed` in one call
    and cast to `dtype` (the type they are served in); std 0 is a
    constant."""
    import torch

    drawn = [(n, s, sd, m) for n, s, sd, m in spec if sd > 0]
    total = sum(math.prod(s) for _, s, _, _ in drawn)
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape, std, mean in spec:
        if std > 0:
            n = math.prod(shape)
            t = buf[off:off + n].view(shape) * std + mean
            off += n
        else:
            t = torch.full(shape, float(mean), device=device, dtype=torch.float32)
        out[name] = t.to(dtype)
    del buf
    return out

