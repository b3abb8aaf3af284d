"""Finds a cell's files by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic; the harness reads

* ``configs/<config>.json``: the code, the decoder and its settings, the
  batch, and what the reference assumes;
* ``traffic/<traffic>.json``: the channel's SNR and the block, in batches;
* ``workloads/<cell>.json``: how many blocks the check and the traced slice
  take, and the limit of each number compared;
* ``metrics/<name>.py``: each per-layer metric's reader; a name whose
  last dotted part names the end-to-end metric it was split for
  (``device.idle_share.bp``) may share the reader of the name without it;
* ``reference/<decoder>.py``: the decoder's plain reference.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def load_module(path: Path, tag: str):
    """Import a file of the benchmark by its path (names may hold dots or
    dashes)."""
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``workloads`` and the files it names."""

    def __init__(self, name: str):
        man = manifest()
        entries = {w["name"]: w for w in man["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                           f"{sorted(entries)}")
        entry = entries[name]
        self.name = name
        self.chips = int(entry["chips"])
        self.config = _json(BENCH / "configs" / f"{entry['config']}.json")
        self.traffic = _json(BENCH / "traffic" / f"{entry['traffic']}.json")
        self.spec = _json(BENCH / "workloads" / f"{name}.json")
        self.end_to_end = [m for m in man["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in man["per_layer"]
                          if name in m["workloads"]]

    @property
    def code_path(self) -> Path:
        return ROOT / self.config["code"]

    def reference(self):
        """The decoder's reference module."""
        kind = self.config["decoder"]
        return load_module(BENCH / "reference" / f"{kind}.py",
                           f"ldpc_bench.reference.{kind.replace('-', '_')}")

    def reference_config(self) -> dict:
        return {**self.config["decoder_config"], **self.config["assumed"]}

    def metric(self, name: str):
        path = BENCH / "metrics" / f"{name}.py"
        if not path.is_file():
            path = path.with_name(f"{name.rsplit('.', 1)[0]}.py")
        return load_module(path, "ldpc_bench_metric_" + name.replace(".", "_"))
