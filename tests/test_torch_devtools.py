"""The port's swtpu-lint (seaweedfs_tpu_torch/devtools/swtpu_lint.py)
against the JAX package's: every rule snippet of tests/test_devtools.py,
suppressions included, gives the same findings from both linters; the
port's tree has 0 findings under either; the CLI's exit codes, JSON
document and rule list are the reference's."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from seaweedfs_tpu.devtools import swtpu_lint as ref_lint
from seaweedfs_tpu_torch.devtools import swtpu_lint as lint

PORT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(lint.__file__)))
REPO = os.path.dirname(PORT_DIR)

SNIPPETS = {
    "rule_async_blocking": """\
        import time
        async def handler():
            time.sleep(1)
""",
    "rule_async_blocking_aliased_import": """\
        import time as _t
        async def handler():
            _t.sleep(1)
""",
    "rule_io_under_lock": """\
        import threading
        import time
        _lock = threading.Lock()
        def sweep():
            with _lock:
                time.sleep(0.1)
""",
    "rule_io_under_lock_allows_local_file_io": """\
        import threading
        _lock = threading.Lock()
        def read_index(path):
            with _lock:
                with open(path, "rb") as f:
                    return f.read()
""",
    "rule_io_under_lock_rpc": """\
        import threading
        _lock = threading.Lock()
        def heal(stub, req):
            with _lock:
                return stub.call("VolumeCopy", req)
""",
    "rule_pread_under_lock": """\
        import os
        import threading
        _lock = threading.Lock()
        def read_record(fd, off, ln):
            with _lock:
                return os.pread(fd, ln, off)
""",
    "rule_pread_outside_lock_not_flagged": """\
        import os
        import threading
        _lock = threading.Lock()
        def read_record(fd, off, ln):
            with _lock:
                committed = off + ln
            return os.pread(fd, ln, off) if committed else b""
        def locked_buffered_read(f, off, ln):
            with _lock:
                f.seek(off)
                return f.read(ln)
""",
    "rule_wallclock_duration": """\
        import time
        def expired(t0, timeout):
            return time.time() - t0 > timeout
""",
    "rule_wallclock_duration_dataflow": """\
        import time
        def age(started):
            now = time.time()
            return now - started
""",
    "rule_wallclock_timestamp_not_flagged": """\
        import time
        def stamp():
            return int(time.time() * 1000)
        def record():
            ts = time.time()
            return {"at": ts}
""",
    "rule_silent_except": """\
        def f(risky):
            try:
                risky()
            except Exception:
                pass
""",
    "rule_silent_except_logged_not_flagged": """\
        import logging
        def f(risky):
            try:
                risky()
            except Exception as e:
                logging.debug("risky failed: %s", e)
""",
    "rule_thread_no_join": """\
        import threading
        def spawn():
            t = threading.Thread(target=print)
            t.start()
""",
    "rule_thread_daemon_or_joined_not_flagged": """\
        import threading
        def spawn_daemon():
            t = threading.Thread(target=print, daemon=True)
            t.start()
        def spawn_joined():
            t = threading.Thread(target=print)
            t.start()
            t.join()
        def spawn_batch(n):
            ts = [threading.Thread(target=print) for _ in range(n)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
""",
    "rule_md5_fips": """\
        import hashlib
        def etag(b):
            return hashlib.md5(b).hexdigest()
""",
    "rule_md5_fips_usedforsecurity_not_flagged": """\
        import hashlib
        def etag(b):
            return hashlib.md5(b, usedforsecurity=False).hexdigest()
""",
    "rule_executor_no_context": """\
        def offload(loop, fn):
            return loop.run_in_executor(None, fn)
        def fan_out(pool, fn):
            return pool.submit(fn)
""",
    "rule_executor_with_context_not_flagged": """\
        import contextvars
        def offload(loop, fn):
            ctx = contextvars.copy_context()
            return loop.run_in_executor(None, ctx.run, fn)
        def fan_out(pool, fn):
            return pool.submit(contextvars.copy_context().run, fn)
""",
    "rule_ack_before_fsync": """\
        import os
        def put(f, data, conn):
            f.write(data)
            conn.send_response(b"ok")
            os.fsync(f.fileno())
""",
    "rule_ack_after_fsync_not_flagged": """\
        import os
        def put(f, data, conn):
            f.write(data)
            os.fsync(f.fileno())
            conn.send_response(b"ok")
        def put2(f, g, data, conn):
            f.write(data)
            conn.send_response(b"ok")
            os.fsync(g.fileno())
""",
    "rule_rename_no_dir_fsync": """\
        import os
        def swap(tmp, dst):
            os.replace(tmp, dst)
""",
    "rule_rename_with_dir_fsync_not_flagged": """\
        import os
        from seaweedfs_tpu_torch.utils import fsutil
        def swap(tmp, dst):
            os.replace(tmp, dst)
            fsutil.fsync_dir(dst)
        def swap2(tmp, dst):
            os.replace(tmp, dst)
            _fsync_dir(dst)
""",
    "rule_vif_write_bypass": """\
        def stamp(base, blob):
            with open(base + ".vif", "wb") as f:
                f.write(blob)
        def stamp2(vif_path, blob):
            with open(vif_path, "w") as f:
                f.write(blob)
""",
    "rule_vif_read_not_flagged": """\
        import json
        def read(base):
            with open(base + ".vif") as f:
                return json.load(f)
""",
    "rule_parse_error": """\
        def broken(:
""",
    "suppression_comment_honored": """\
        import threading
        import time
        _lock = threading.Lock()
        def sweep():
            with _lock:
                time.sleep(0.1)  # swtpu-lint: disable=io-under-lock (handoff pause)
""",
    "suppression_all_and_wrong_rule_0": """\
        import hashlib
        def a(b):
            return hashlib.md5(b).digest()  # swtpu-lint: disable=silent-except
""",
    "suppression_all_and_wrong_rule_1": """\
        import hashlib
        def a(b):
            return hashlib.md5(b).digest()  # swtpu-lint: disable=all
""",
}


def _findings(mod, path):
    return [(f.rule, f.line, f.col, f.message) for f in mod.lint_file(path)]


@pytest.mark.parametrize("case", list(SNIPPETS))
def test_rule_findings_equal_reference(tmp_path, case):
    p = tmp_path / "fx.py"
    p.write_text(textwrap.dedent(SNIPPETS[case]))
    got = _findings(lint, str(p))
    assert got == _findings(ref_lint, str(p))
    flagged = not case.endswith(("_not_flagged", "_allows_local_file_io",
                                 "_honored", "_1"))
    assert bool(got) == flagged, got


def test_port_tree_has_no_findings():
    findings, nfiles = lint.lint_paths([PORT_DIR])
    assert nfiles > 130
    assert findings == [], "\n".join(f.render() for f in findings)
    ref_findings, ref_nfiles = ref_lint.lint_paths([PORT_DIR])
    assert (ref_findings, ref_nfiles) == ([], nfiles)


def test_cli_matches_reference(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("import hashlib\nh = hashlib.md5(b'x')\n")
    clean = tmp_path / "ok.py"
    clean.write_text("x = 1\n")
    for mod in (lint, ref_lint):
        assert mod.main([str(bad)]) == 1
        assert mod.main([str(clean)]) == 0
        assert mod.main(["--select", "no-such-rule", str(clean)]) == 2
    capsys.readouterr()
    docs = []
    for mod in (lint, ref_lint):
        assert mod.main(["--json", str(bad)]) == 1
        docs.append(json.loads(capsys.readouterr().out))
    assert docs[0] == docs[1] and docs[0]["count"] == 1
    assert lint.main(["--list-rules"]) == 0
    port_rules = capsys.readouterr().out
    ref_lint.main(["--list-rules"])
    assert port_rules == capsys.readouterr().out
    assert "ack-before-fsync" in port_rules


def test_module_entrypoint_lints_the_port_by_default():
    r = subprocess.run([sys.executable, "-m",
                        "seaweedfs_tpu_torch.devtools.swtpu_lint"],
                       capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stdout[-2000:]
    assert r.stdout.strip().startswith("swtpu-lint: 0 finding(s) in ")
