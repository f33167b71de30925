"""The benchmark finds a cell's parts by name, so that a later change adds
files and entries and edits none; and nothing it runs loads JAX or the
JAX package."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "seaweedfs_tpu"}


def _copy(tmp_path: Path) -> Path:
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "weedbench", tmp_path / "weedbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def _py(cwd: Path, code: str) -> str:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_a_config_a_mix_and_a_metric_added_as_files(tmp_path):
    root = _copy(tmp_path)
    wb = root / "weedbench"
    cfg = json.loads((wb / "configs" / "rs14_2-filer-chunks.json").read_text())
    cfg["name"] = "rs6_3-tiny"
    cfg.update(d=6, p=3, racks=3)
    (wb / "configs" / "rs6_3-tiny.json").write_text(json.dumps(cfg))
    (wb / "traffic" / "get_tiny.json").write_text(json.dumps(
        {"kind": "paced_get", "objects_per_s": 5, "workers": 4,
         "lose_racks": []}))
    (wb / "metrics" / "tiny_share.get.py").write_text(
        "def read(run):\n    return 42.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "rs6_3-tiny", "source": "https://x",
                             "file": "weedbench/configs/rs6_3-tiny.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "rs6_3.get_tiny",
                               "config": "rs6_3-tiny", "traffic": "get_tiny",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"][1]["workloads"].append("rs6_3.get_tiny")
    bench["per_layer"].append({"name": "tiny_share.get", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "get_rps",
                               "workloads": ["rs6_3.get_tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in ROOT.joinpath("weedbench").rglob(
        "*") if p.is_file() and "__pycache__" not in p.parts}
    out = _py(root, """
import json
from pathlib import Path
from weedbench import spec
b = spec.load_benchmark(Path('.'))
w = spec.workload(b, 'rs6_3.get_tiny')
c = spec.config(b, Path('.'), w['config'])
t = spec.traffic(w['traffic'])
k = spec.kind(t['kind'])
print(json.dumps({'d': c['d'], 'kind': k.__name__,
    'e2e': [m['name'] for m in spec.end_to_end(b, w['name'])],
    'layer': [m['name'] for m in spec.per_layer(b, w['name'])],
    'value': spec.reader('tiny_share.get').read(None),
    'here': str(spec.HERE)}))
""")
    got = json.loads(out)
    assert got["d"] == 6 and got["kind"] == "weedbench.kinds.paced_get"
    assert got["e2e"] == ["setup_s", "get_rps"]
    assert got["layer"] == ["tiny_share.get"] and got["value"] == 42.0
    assert Path(got["here"]) == root / "weedbench"
    after = {p: p.read_bytes() for p in before}
    assert after == before  # nothing of the repository's copy was edited


def test_nothing_the_benchmark_imports_is_jax_or_the_jax_package():
    """Every module of weedbench/ and every module of the program it
    imports, by name: no top-level jax, jaxlib, flax or seaweedfs_tpu
    (names compared whole: the port's name begins with the JAX
    package's)."""
    mods, program = [], set()
    for p in sorted((ROOT / "weedbench").rglob("*.py")):
        rel = p.relative_to(ROOT)
        if "tests" in rel.parts or "metrics" in rel.parts:
            continue
        mods.append(".".join(rel.with_suffix("").parts).replace(
            ".__init__", "").replace(".__main__", ""))
        src = p.read_text()
        program |= set(re.findall(r"from (seaweedfs_tpu_torch[\w.]*) import",
                                  src))
        program |= set(re.findall(r"^\s*import (seaweedfs_tpu_torch[\w.]*)",
                                  src, re.M))
    readers = [p.stem for p in (ROOT / "weedbench" / "metrics").glob("*.py")]
    out = _py(ROOT, f"""
import importlib, sys
for m in {sorted(set(mods) | program)!r}:
    importlib.import_module(m)
from weedbench import spec
for r in {readers!r}:
    spec.reader(r)
print(sorted({{m.split('.')[0] for m in sys.modules}}))
""")
    top = set(eval(out))  # a list of names printed by the child
    assert not top & FORBIDDEN, top & FORBIDDEN
    assert "seaweedfs_tpu_torch" in top and "weedbench" in top


def test_the_reference_imports_nothing_of_the_program():
    out = _py(ROOT, """
import sys
import weedbench.reference.gf256, weedbench.reference.crc32c
import weedbench.reference.needles, weedbench.reference.stripes
print(sorted({m.split('.')[0] for m in sys.modules}))
""")
    top = set(eval(out))
    assert not top & (FORBIDDEN | {"seaweedfs_tpu_torch", "torch"})


def test_a_checkout_of_the_benchmark_alone_exits_non_zero(tmp_path):
    root = _copy(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "weedbench", "--workload",
         "rs14_2.get_diskloss_chunks", "--seed", "1", "--seconds", "1",
         "--rehearse", "--scale", "0.07"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip()
