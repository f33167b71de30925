"""The port's crash-state enumerator (seaweedfs_tpu_torch/devtools/
crashsim.py) against the JAX package's: the reference's hand-built traces
give equal crash states from both enumerators, and the same semantics
(fsync pins a prefix, un-fsynced suffixes drop, only the final write
tears, un-pinned renames roll back, acked marks follow the prefix); the
port's six scenarios (single-put, bulk-frame, ec-seal, raft-commit,
vif-stamp, meta-log, over the port's Volume, streaming encoder, raft, .vif
and filer meta log) are clean and reach 500 states together, ec-seal with
its coder on the CPU; meta-log's states equal the reference's;
the ec-seal trace holds the writer pool's pwrites and the shard files'
truncates; the seeded ack-before-fsync mutant trips both the simulator and
the port's lint; the CLI's artifact and exit codes are the reference's."""

import json
import os
import random
import textwrap

import pytest

from seaweedfs_tpu.devtools import crashsim as ref_crashsim
from seaweedfs_tpu.utils import fstrack as ref_fstrack
from seaweedfs_tpu_torch.devtools import crashsim, swtpu_lint
from seaweedfs_tpu_torch.utils import fstrack

PACKAGES = {"port": (crashsim, fstrack), "ref": (ref_crashsim, ref_fstrack)}


def _case_fsync_pins(F):
    return [F(1, "create", path="/w/f"),
            F(2, "write", path="/w/f", offset=0, data=b"abcd"),
            F(3, "fsync", path="/w/f"),
            F(4, "write", path="/w/f", offset=4, data=b"ef")], {}


def _case_unsynced_tail(F):
    return [F(1, "create", path="/w/f"),
            F(2, "write", path="/w/f", offset=0, data=b"abcdef")], {}


def _case_tear_final_only(F):
    return [F(1, "create", path="/w/f"),
            F(2, "write", path="/w/f", offset=0, data=b"aaaa"),
            F(3, "write", path="/w/f", offset=4, data=b"bbbb")], {}


def _case_unpinned_rename(F):
    return [F(1, "create", path="/w/t"),
            F(2, "write", path="/w/t", offset=0, data=b"v2"),
            F(3, "fsync", path="/w/t"),
            F(4, "rename", path="/w/t", dst="/w/f")], {"/w/f": b"v1"}


def _case_dir_fsync_pins(F):
    ops, snap = _case_unpinned_rename(F)
    return ops + [F(5, "fsync_dir", path="/w")], snap


def _case_acked_marks(F):
    return [F(1, "create", path="/w/f"),
            F(2, "write", path="/w/f", offset=0, data=b"x"),
            F(3, "fsync", path="/w/f"),
            F(4, "mark", label="ack", meta={"key": 1}),
            F(5, "write", path="/w/f", offset=1, data=b"y")], {}


def _case_two_files(F):
    return [F(1, "create", path="/w/a"),
            F(2, "write", path="/w/a", offset=0, data=b"0123456789"),
            F(3, "create", path="/w/b"),
            F(4, "write", path="/w/b", offset=0, data=b"abcdefgh"),
            F(5, "unlink", path="/w/c"),
            F(6, "trunc", path="/w/a", length=4),
            F(7, "fsync", path="/w/b")], {"/w/c": b"old"}


CASES = {f.__name__[6:]: f for f in (
    _case_fsync_pins, _case_unsynced_tail, _case_tear_final_only,
    _case_unpinned_rename, _case_dir_fsync_pins, _case_acked_marks,
    _case_two_files)}


def _states(pkg, case):
    cs, fs = PACKAGES[pkg]
    ops, snap = CASES[case](fs.FsOp)
    fams = cs._families([o for o in ops if o.kind != "mark"])
    states = [({p: bytes(b) for p, b in files.items()},
               [(m.seq, m.label, m.meta) for m in acked], why)
              for files, acked, why in cs.enumerate_states(
                  ops, snap, random.Random(0), torn_cuts=4)]
    return (fams[0], sorted((p, o.seq) for p, o in fams[1].items())), states


@pytest.mark.parametrize("case", list(CASES))
def test_enumeration_equals_reference(case):
    port_fams, port = _states("port", case)
    ref_fams, ref = _states("ref", case)
    assert port_fams == ref_fams
    assert port == ref
    contents = {tuple(sorted(files.items())) for files, _, _ in port}
    assert len(contents) == len(port)  # deduplicated
    if case == "fsync_pins":  # every state is a prefix of the writes
        for files, _, _ in port:
            if files:
                assert b"abcdef".startswith(files["/w/f"])
    elif case == "unsynced_tail":
        bodies = {f["/w/f"] for f, _, _ in port if f}
        assert {b"abcdef", b""} <= bodies
        assert any(0 < len(b) < 6 for b in bodies)
    elif case == "tear_final_only":
        for files, _, why in port:
            if "torn" in why and why.startswith("crash after op3"):
                assert files["/w/f"][:4] == b"aaaa"
    elif case == "unpinned_rename":
        assert {"/w/f": b"v2"} in [f for f, _, _ in port]
        assert {"/w/f": b"v1", "/w/t": b"v2"} in [f for f, _, _ in port]
    elif case == "dir_fsync_pins":
        assert port_fams == ([], [])
    elif case == "acked_marks":
        by_why = {why: acked for _, acked, why in port}
        assert by_why["crash after op2:write"] == []
        assert [m[2]["key"] for m in by_why["crash after op5:write"]] == [1]


def _scenario(name):
    return next(s for s in crashsim.scenarios("cpu") if s.name == name)


@pytest.mark.parametrize("name", ["single-put", "bulk-frame", "ec-seal",
                                  "raft-commit", "vif-stamp", "meta-log"])
def test_port_scenarios_clean(name):
    rep = crashsim.run_scenario(_scenario(name), seed=1, max_states=150)
    assert rep["violations"] == []
    assert rep["states"] >= 20 and rep["ops"] > 0


def test_matrix_reaches_500_states_and_cli_artifact(tmp_path, capsys):
    art = tmp_path / "CRASHSIM.json"
    assert crashsim.main(["--device", "cpu", "--min-states", "500",
                          "--artifact", str(art)]) == 0
    doc = json.loads(art.read_text())
    assert [s["scenario"] for s in doc["scenarios"]] == [
        "single-put", "bulk-frame", "ec-seal", "raft-commit", "vif-stamp",
        "meta-log"]
    assert doc["total_states"] >= 500 and doc["total_violations"] == 0
    assert doc["total_states"] == sum(s["states"] for s in doc["scenarios"])
    ref_art = tmp_path / "REF.json"
    assert ref_crashsim.main(["--scenario", "vif-stamp", "--artifact",
                              str(ref_art), "--max-states", "120"]) == 0
    got_art = tmp_path / "GOT.json"
    assert crashsim.main(["--scenario", "vif-stamp", "--artifact",
                          str(got_art), "--max-states", "120"]) == 0
    assert json.loads(got_art.read_text()) == json.loads(ref_art.read_text())
    # the filer meta log: the port's log over the same seed gives the
    # reference's states (98 at seed 0), every one a clean prefix
    for seed in (0, 3):
        ref_art = tmp_path / f"REF-ML{seed}.json"
        assert ref_crashsim.main(["--scenario", "meta-log", "--artifact",
                                  str(ref_art), "--seed", str(seed)]) == 0
        got_art = tmp_path / f"GOT-ML{seed}.json"
        assert crashsim.main(["--scenario", "meta-log", "--artifact",
                              str(got_art), "--seed", str(seed)]) == 0
        got = json.loads(got_art.read_text())
        assert got == json.loads(ref_art.read_text())
        assert got["total_violations"] == 0
        assert seed or got["total_states"] == 98
    capsys.readouterr()
    assert crashsim.main(["--scenario", "no-such"]) == 2
    assert ref_crashsim.main(["--scenario", "no-such"]) == 2
    assert crashsim.main(["--list"]) == 0
    listed = capsys.readouterr().out
    assert "ec-seal" in listed and "mutant-ack-before-fsync" in listed
    assert "meta-log" in listed


def test_ec_seal_trace_holds_pool_pwrites_and_truncates(tmp_path):
    sc = _scenario("ec-seal")
    rng = random.Random(3)
    ctx = {}
    sc.setup(str(tmp_path), ctx, rng)
    fstrack.install()
    try:
        fstrack.start_trace(str(tmp_path))
        sc.run(str(tmp_path), ctx, rng)
        ops = fstrack.stop_trace()
    finally:
        fstrack.uninstall()
    shard = lambda o: o.path is not None and os.path.basename(
        o.path).startswith("1.ec") and o.path[-2:].isdigit()  # noqa: E731
    writes = [o for o in ops if o.kind == "write" and shard(o)]
    truncs = [o for o in ops if o.kind == "trunc" and shard(o)]
    fsyncs = [o for o in ops if o.kind == "fsync" and shard(o)]
    assert {os.path.basename(o.path) for o in writes} == \
        {f"1.ec{i:02d}" for i in range(6)}
    assert len(truncs) == 6 and len({o.length for o in truncs}) == 1
    # every shard byte written lands inside the truncated size, and the
    # shards are fsynced before the .ecx and the .vif are written
    size = truncs[0].length
    assert all(o.offset + len(o.data) <= size for o in writes)
    assert len(fsyncs) == 6
    seal = min(o.seq for o in ops
               if o.path and o.path.endswith((".ecx", ".vif")))
    assert max(o.seq for o in fsyncs) < seal
    assert max(o.seq for o in writes) < min(o.seq for o in fsyncs)


def test_mutant_caught_by_crashsim_and_lint(tmp_path):
    rep = crashsim.run_scenario(crashsim.MUTANTS["mutant-ack-before-fsync"],
                                seed=0, max_states=400)
    assert rep["violations"]
    assert any("acked" in v for st in rep["violations"]
               for v in st["errors"])
    assert crashsim.main(["--scenario", "mutant-ack-before-fsync",
                          "--max-states", "200"]) == 1
    p = tmp_path / "mutant.py"
    p.write_text(textwrap.dedent("""\
        import os
        def bulk_put(dat, frames, conn):
            for frame in frames:
                dat.write(frame)
                conn.send_ack(b"ok")
            os.fsync(dat.fileno())
        """))
    assert {f.rule for f in swtpu_lint.lint_file(str(p))} == \
        {"ack-before-fsync"}
    assert swtpu_lint.main([str(p)]) == 1


def test_crash_round_trip_of_chip_smoke_on_cpu(tmp_path):
    """Phase 19 of chip_smoke.py with ec-seal's coder on the CPU: the
    matrix of six scenarios past 500 states clean, the mutant caught, the
    lint clean."""
    import chip_smoke
    res = chip_smoke.crash_round_trip(str(tmp_path), 0, "cpu", 500,
                                      device="cpu")
    assert res["total"] >= 500 and len(res["states"]) == 6
    assert res["states"]["meta-log"] == 98
    assert res["lint_files"] > 130
