"""BENCHMARK.json against the contract's shape, and every cell's files found
by name."""

import json
import re

import pytest

from portbench import harness as H

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

MAN = H.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]


def one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(MAN) == TOP_KEYS
    assert (H.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert 1 <= len(MAN["paths"]) <= 16 and all(PATH.match(p) for p in MAN["paths"])
    assert 1 <= len(MAN["command"]) <= 32 and all(one_line(w) for w in MAN["command"])
    for word in MAN["command"]:
        assert not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_allowed_and_distinct(section):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    keys = {"name", "source", "file", "reduced", "why"}
    for c in MAN["configs"]:
        assert set(c) == keys
        assert one_line(c["source"]) and one_line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in MAN["paths"]))
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        cfg = json.loads((H.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert any(w["config"] == c["name"] for w in MAN["workloads"])


def test_workloads():
    pairs = set()
    n4 = 0
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and one_line(w["why"])
        assert w["chips"] in (1, 4)
        n4 += w["chips"] == 4
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert n4 <= max(1, len(MAN["workloads"]) // 4)


def test_metrics():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and one_line(m["layer"])
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = H.cell(name, MAN)
    mod = H.kind_module(cell.traffic["kind"])
    assert hasattr(mod, "Run") and hasattr(mod, "SPAN")
    assert H.config_module(cell.config, "reference")
    assert H.config_module(cell.config, "program")
    for m in cell.per_layer:
        assert callable(H.metric_reader(m["name"]).read)
    assert set(cell.traffic["limits"]) and all(v > 0 for v in cell.traffic["limits"].values())


@pytest.mark.parametrize("name", CELLS)
def test_cell_reports_what_the_contract_asks(name):
    cell = H.cell(name, MAN)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("family", ["gemm", "attn", "fp32"])
def test_kernel_families_name_kernels(family):
    assert H.kernel_names(family)
