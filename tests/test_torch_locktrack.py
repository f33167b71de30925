"""The port's lock-order detector (seaweedfs_tpu_torch/utils/locktrack.py)
against the JAX package's: the same ABBA script, run in a subprocess under
each package's SWTPU_LOCKCHECK=1, gives the same cycle findings (lock names
compared with the package's name taken out of their creation sites), and
findings are scoped to the port's own frames: a cycle of locks created in a
directory beside the port's whose name starts like it, or in the JAX
package, is not the port's to report. Exact comparisons; no tolerance."""

import json
import os
import subprocess
import sys

import pytest

from seaweedfs_tpu_torch.utils import locktrack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r'''
import importlib, json, os, sys, threading

pkg = sys.argv[1]
importlib.import_module(pkg)  # its __init__ installs the detector
lt = importlib.import_module(pkg + ".utils.locktrack")
assert lt.installed() and threading.Lock is lt.Lock


def abba(a, b):
    """A then B on one thread, B then A on another, one after the other:
    no deadlock happens, the order graph closes a cycle."""
    def first():
        with a:
            with b:
                pass

    def second():
        with b:
            with a:
                pass
    for fn in (first, second):
        t = threading.Thread(target=fn)
        t.start()
        t.join()


def locks_from(path):
    """Two locks whose creation frame is in `path`."""
    ns = {}
    exec(compile("import threading\nX = threading.Lock()\n"
                 "Y = threading.RLock()\n", path, "exec"), ns)
    return ns["X"], ns["Y"]


out = {}
root = lt._PKG_ROOT
cases = {
    "named": (lt.Lock(name="A"), lt.Lock(name="B")),
    "script": (threading.Lock(), threading.Lock()),
    "package": locks_from(os.path.join(root, "scoped.py")),
    "sibling": locks_from(root + "_sibling" + os.sep + "scoped.py"),
    "other_package": locks_from(os.path.join(
        os.path.dirname(root),
        "seaweedfs_tpu" if pkg == "seaweedfs_tpu_torch"
        else "seaweedfs_tpu_torch", "scoped.py")),
}
for case, (a, b) in cases.items():
    lt.reset()
    abba(a, b)
    f = lt.findings()
    out[case] = sorted(sorted(c["locks"]) for c in f["cycles"])
print(json.dumps(out))
'''


def _findings(pkg, tmp_path):
    script = tmp_path / "abba.py"
    script.write_text(SCRIPT)
    env = dict(os.environ, SWTPU_LOCKCHECK="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, str(script), pkg], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    # creation sites name the package's directory: take it out
    return {case: [[name.replace(pkg + os.sep, "PKG" + os.sep)
                    .replace(pkg + "_sibling", "PKG_sibling")
                    for name in cyc] for cyc in cycles]
            for case, cycles in out.items()}


@pytest.fixture(scope="module")
def findings(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("locktrack")
    return {pkg: _findings(pkg, tmp)
            for pkg in ("seaweedfs_tpu_torch", "seaweedfs_tpu")}


@pytest.mark.parametrize("case", ["named", "script", "package"])
def test_abba_findings_equal_reference(findings, case):
    port, ref = findings["seaweedfs_tpu_torch"][case], \
        findings["seaweedfs_tpu"][case]
    assert port == ref
    assert len(port) == (0 if case == "script" else 1)


def test_named_cycle_lists_both_locks(findings):
    assert findings["seaweedfs_tpu_torch"]["named"] == [["A", "B"]]


def test_findings_scoped_to_the_ports_frames(findings):
    port = findings["seaweedfs_tpu_torch"]
    # a directory beside the port's whose name extends it is not the port
    assert port["sibling"] == []
    # nor is the JAX package
    assert port["other_package"] == []
    # the reference's bare prefix test counts its sibling's frames as its
    # own (seaweedfs_tpu_sibling/, and the port's seaweedfs_tpu_torch/)
    ref = findings["seaweedfs_tpu"]
    assert len(ref["sibling"]) == 1 and len(ref["other_package"]) == 1


def test_creator_scope_matches_whole_path_components():
    root = locktrack._PKG_ROOT
    assert locktrack._PKG_PREFIX == root + os.sep

    def created_in(path):
        ns = {"lt": locktrack}
        exec(compile("X = lt.TrackedLock()\n", path, "exec"), ns)
        return ns["X"]._id in locktrack._state.own

    assert created_in(os.path.join(root, "server", "x.py"))
    assert not created_in(root + "_sibling" + os.sep + "x.py")
    assert not created_in(os.path.join(os.path.dirname(root),
                                       "seaweedfs_tpu", "x.py"))


def test_debug_locks_payload_without_install():
    payload = locktrack.debug_locks_payload({})
    assert payload["enabled"] is locktrack.installed()
    assert set(payload) == {"enabled", "locks_tracked", "locks_untracked",
                            "edges", "hold_threshold_ms", "cycles",
                            "long_holds"}
    assert "edge_list" in locktrack.debug_locks_payload({"edges": "1"})
