"""Running the benchmark's command from a test and reading its last line."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]

def run_cell(workload: str, seed: int, *extra: str, seconds: float = 2,
             timeout: float = 900, root: Path = ROOT
             ) -> "tuple[dict, str]":
    """The last line of one run from `root`, and its standard error."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-m", "weedbench", "--workload", workload,
         "--seed", str(seed), "--seconds", str(seconds), *extra],
        cwd=root, env=env, capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr
