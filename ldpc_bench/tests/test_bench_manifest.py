"""``BENCHMARK.json`` keeps the contract's shape, and every cell's files are
found by name."""
import json
import re

import pytest

from ldpc_bench.cell import BENCH, ROOT, Cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_top_level_keys_and_size(manifest):
    assert set(manifest) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51


def test_command_and_paths(manifest):
    cmd = manifest["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert not any(w.startswith("/") or ".." in w for w in cmd)
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.endswith("_torch")
        assert (ROOT / p).is_dir()


def test_names_units_and_entries(manifest):
    shapes = {"configs": {"name", "source", "file", "reduced", "why"},
              "workloads": {"name", "config", "traffic", "chips", "why"},
              "end_to_end": {"name", "unit", "better", "bound", "source"},
              "per_layer": {"name", "unit", "better", "source", "layer",
                            "moves"}}
    for key, want in shapes.items():
        names = [e["name"] for e in manifest[key]]
        assert len(names) == len(set(names))
        for e in manifest[key]:
            assert set(e) - {"workloads"} == want, (key, e["name"])
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
            for text in ("why", "layer", "source"):
                if text in e and key in ("configs", "workloads",
                                         "per_layer"):
                    assert _line(e[text]), (e["name"], text)


def test_bounds_and_sources(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in manifest["workloads"]}
    for m in e2e.values():
        assert set(m.get("workloads", cells)) <= cells, m["name"]
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        assert m["workloads"] and set(m["workloads"]) <= cells, m["name"]
        # each cell that reports it reports the metric it moves
        assert set(m["workloads"]) <= set(
            e2e[m["moves"]].get("workloads", cells)), m["name"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["unit"] == "%":
            assert m["name"].endswith("_roofline")


def test_cells_configs_and_traffic(manifest):
    cells = manifest["workloads"]
    assert 1 <= len(cells) <= 24
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    used = {w["config"] for w in cells}
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))
    for c in manifest["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in
                                          manifest["paths"]))
        with open(ROOT / c["file"]) as f:
            data = json.load(f)
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert (ROOT / data["code"]).is_file()
    for w in cells:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)


@pytest.mark.parametrize("cell", ["bp100-optimalH-m3db", "alp-optimalH-m3db",
                                  "alp-optimalH-0db"])
def test_cell_files_found_by_name(cell):
    c = Cell(cell)
    assert c.code_path.is_file()
    assert c.traffic["block_batches"] >= 1 and c.config["batch"] >= 1
    ref = c.reference()
    assert hasattr(ref, "prepare") and hasattr(ref, "decode")
    e2e = [m["name"] for m in c.end_to_end]
    assert sorted(n.split(".")[0] for n in e2e) == ["cw_per_s", "setup_s"]
    assert c.per_layer
    for m in c.per_layer:
        assert hasattr(c.metric(m["name"]), "read")
    assert set(c.spec["limits"]) >= {"llr_gap", "classify_gap"}


def test_every_file_is_named_from_name_characters():
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel
