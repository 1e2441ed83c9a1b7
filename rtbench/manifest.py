"""``BENCHMARK.json`` and the files it names: a cell resolves to its
configuration, traffic mix and limits files, and to the readers of its
per-layer metrics, all found by name under this folder."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


class ManifestError(ValueError):
    pass


def load(path=None) -> dict:
    """The manifest at ``path`` (default: ``BENCHMARK.json`` at the root)."""
    path = Path(path) if path is not None else ROOT / "BENCHMARK.json"
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise ManifestError(f"no manifest at {path}") from None


def _named(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise ManifestError(f"no {what} named {name!r} in the manifest")


def read_json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise ManifestError(f"missing file {path}") from None


class Cell:
    """One workload of the manifest with everything it names, read from
    the files under ``bench_dir``."""

    def __init__(self, manifest: dict, workload: str, bench_dir: Path = BENCH_DIR):
        self.manifest = manifest
        self.entry = _named(manifest["workloads"], workload, "workload")
        self.name = workload
        self.chips = int(self.entry["chips"])
        cfg = _named(manifest["configs"], self.entry["config"], "configuration")
        root = bench_dir.parent
        self.config = read_json(root / cfg["file"])
        self.config_name = cfg["name"]
        self.traffic_name = self.entry["traffic"]
        self.traffic = read_json(bench_dir / "traffic" / f"{self.traffic_name}.json")
        self.limits = read_json(bench_dir / "limits" / f"{workload}.json")
        self.bench_dir = bench_dir

    def end_to_end(self) -> list:
        return [m for m in self.manifest["end_to_end"]
                if workload_has(m, self.name)]

    def per_layer(self) -> list:
        return [m for m in self.manifest["per_layer"]
                if workload_has(m, self.name)]

    def reader(self, metric: str):
        """The ``read`` function of ``metrics/<metric>.py``."""
        return load_reader(self.bench_dir / "metrics" / f"{metric}.py")


def workload_has(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_module(path: Path, what: str):
    """The module of the file ``path``, one of the benchmark's ``what``."""
    if not path.exists():
        raise ManifestError(f"missing {what} {path}")
    spec = importlib.util.spec_from_file_location(
        f"rtbench_{what.replace(' ', '_')}_" + re.sub(r"\W", "_", path.stem), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(path: Path):
    return load_module(path, "metric reader").read


def problems(manifest: dict) -> list:
    """What in ``manifest`` breaks the naming rules: every name, config,
    traffic and reduced key a name, every unit a unit, every metric's
    ``moves`` an end-to-end metric, every metric ``workloads`` a cell."""
    found = []
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"] for m in manifest["end_to_end"]}
    names = [c["name"] for c in manifest["configs"]]
    names += [w["name"] for w in manifest["workloads"]]
    names += [w[k] for w in manifest["workloads"] for k in ("config", "traffic")]
    names += [k for c in manifest["configs"] for k in c["reduced"]]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        names.append(m["name"])
        if not UNIT.match(m["unit"]):
            found.append(f"unit {m['unit']!r} of {m['name']}")
        if m["better"] not in ("lower", "higher"):
            found.append(f"better {m['better']!r} of {m['name']}")
        for w in m.get("workloads", ()):
            if w not in cells:
                found.append(f"{m['name']} names no cell {w!r}")
    for m in manifest["per_layer"]:
        if m["moves"] not in e2e:
            found.append(f"{m['name']} moves no end-to-end metric {m['moves']!r}")
    found += [f"name {n!r}" for n in names if not NAME.match(str(n))]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [e["name"] for e in manifest[kind]]
        found += [f"{kind} name {n!r} twice" for n in set(seen) if seen.count(n) > 1]
    return found
