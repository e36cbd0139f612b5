"""BENCHMARK.json against the rules a manifest keeps (names, units, keys,
bounds, what each cell reports), and every file a cell needs found by its
name."""

import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert isinstance(MANIFEST["run_seconds"], int)


def test_command_and_paths():
    cmd, paths = MANIFEST["command"], MANIFEST["paths"]
    assert 1 <= len(cmd) <= 32 and all(LINE.match(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    for word in cmd:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in paths)
            assert (ROOT / word).is_file()


def _metrics():
    return MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_names_and_units():
    names = ([c["name"] for c in MANIFEST["configs"]]
             + [w["name"] for w in MANIFEST["workloads"]]
             + [m["name"] for m in _metrics()])
    assert all(NAME.match(n) for n in names), names
    for group in (MANIFEST["configs"], MANIFEST["workloads"], _metrics()):
        assert len({x["name"] for x in group}) == len(group)
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in _metrics():
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in MANIFEST["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16


def test_entries_have_just_their_keys():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert LINE.match(m["layer"])


def test_every_cell_reports_what_it_must():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    pairs = {(w["config"], w["traffic"]) for w in MANIFEST["workloads"]}
    assert len(pairs) == len(cells)
    e2e = {m["name"]: set(m.get("workloads", cells))
           for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"] == cells
    for m in _metrics():
        assert set(m.get("workloads", cells)) <= cells
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= e2e[m["moves"]]
    for cell in cells:
        assert any(cell in s for n, s in e2e.items() if n != "setup_s")
        assert any(cell in m.get("workloads", cells)
                   for m in MANIFEST["per_layer"])
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}


def test_roofline_and_mfu_names():
    for m in MANIFEST["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_files_resolve(cell):
    from benchmark import harness
    c = harness.load_cell(cell, 1, 1.0, True)
    conf = next(x for x in MANIFEST["configs"] if x["name"] == next(
        w["config"] for w in MANIFEST["workloads"] if w["name"] == cell))
    assert Path(conf["file"]).parts[0] in MANIFEST["paths"]
    assert c.config["name"] == conf["name"]
    assert (BENCH / "drivers" / f"{c.traffic['driver']}.py").is_file()
    for m in c.per_layer:
        reader = harness.load_module(BENCH / "metrics" / f"{m['name']}.py")
        assert callable(reader.read)
    for k, v in c.checks["numbers"].items():
        assert NAME.match(k) and v["limit"] > 0


def test_configs_hold_their_files_alone():
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(set(files)) == len(files)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module


FORBIDDEN = {"jax", "jaxlib", "flax", "grounded_video_description_tpu"}


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_in_the_benchmark(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert "grounded_video_description_torch" not in tops
    assert not tops & FORBIDDEN


def test_whole_name_comparison():
    # the port's name begins with the JAX package's stem: the check
    # compares whole top-level names, so the port passes and the JAX
    # package does not
    port = "grounded_video_description_torch.models.gvd"
    assert port.split(".")[0] not in FORBIDDEN
    assert "grounded_video_description_tpu.models".split(".")[0] in FORBIDDEN
