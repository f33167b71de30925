"""Finding a cell's parts by name: BENCHMARK.json at the checkout's root
names each configuration's file and each cell's traffic mix; a mix is
weedbench/traffic/<name>.json, whose `kind` is the generator module
weedbench/kinds/<kind>.py; a per-layer metric is the reader
weedbench/metrics/<name>.py. Adding any of them adds files and entries,
never edits one."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_benchmark(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, root: Path, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def kind(name: str):
    return importlib.import_module(f"{__package__}.kinds.{name}")


def reader(name: str):
    """The module of per-layer metric `name` (its file name is the
    metric's name, dots and all), loaded by path."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"{__package__}.metrics._" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end(bench: dict, cell: str) -> "list[dict]":
    return [m for m in bench["end_to_end"] if _listed(m, cell)]


def per_layer(bench: dict, cell: str) -> "list[dict]":
    e2e = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]
