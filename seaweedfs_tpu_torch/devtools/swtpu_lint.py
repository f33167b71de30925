"""swtpu-lint: AST rules for the bug classes this codebase actually grows.

The same handful of concurrency patterns kept recurring (I/O while
holding a shared lock, wall-clock deadlines that stall when NTP steps the
clock, `except Exception: pass` hiding real faults, FIPS-fatal
`hashlib.md5`, threads with no stop-path join, executor hops dropping the
active trace context). This linter turns each class into a rule so the
*next* instance fails the lint instead of surviving to a review.

Rules (suppress per line with `# swtpu-lint: disable=<rule>[,<rule>]`):

  async-blocking       blocking call (time.sleep, sync HTTP, subprocess,
                       socket/file I/O) inside an `async def` body —
                       stalls the whole event loop, not one request
  io-under-lock        sleep / sync HTTP / subprocess / cross-node RPC
                       inside a `with <lock>:` block — serializes every
                       other thread behind one peer's timeout (local
                       FILE I/O under a lock is deliberately allowed:
                       per-volume locks protecting their own file are
                       the storage engine's design)
  wallclock-duration   time.time() in duration/deadline arithmetic
                       (subtraction, comparison, `+ timeout`) where
                       time.monotonic() is required; plain timestamp
                       reads (`int(time.time())`, `time.time() * 1000`
                       stored as wall-clock metadata) are not flagged
  silent-except        `except Exception:`/bare `except:` whose body is
                       only pass/... — no log, journal, or fallback
                       value; faults vanish without a trace
  thread-no-join       non-daemon threading.Thread that is never
                       .join()ed (nor kept in a container) in its file —
                       leaks at shutdown and hides crashed workers
  md5-fips             hashlib.md5 without usedforsecurity=False —
                       raises on FIPS-mode kernels (md5 here is always
                       an ETag/fingerprint, never security)
  executor-no-context  run_in_executor / pool.submit without
                       contextvars.copy_context() — the active trace
                       span (tracing/) silently drops across the hop
  pread-under-lock     os.pread/os.preadv while holding a lock — the
                       seqlock read path (storage/volume.py) exists so
                       reads never queue behind a writer's fsync; a
                       pread inside a critical section re-serializes
                       every reader behind that lock's writers
  ack-before-fsync     an ack/response call between a write and the
                       fsync of the SAME fd in one function — the ack
                       stands on data still in page cache; a crash
                       after the reply loses acked bytes (the dynamic
                       mirror is devtools/crashsim.py)
  rename-no-dir-fsync  os.rename/os.replace with no directory fsync
                       (utils/fsutil.fsync_dir) afterwards in the same
                       function — POSIX makes the rename durable only
                       once the PARENT DIRECTORY is fsynced; without
                       it a crash resurrects the old name
  vif-write-bypass     opening a `.vif` for writing outside
                       ec/files.py — every sidecar mutation must go
                       through write_vif/update_vif (atomic tmp+fsync+
                       rename under the per-sidecar lock); a raw write
                       can leave a torn JSON that makes an intact
                       volume unmountable

Output: human `path:line:col: rule: message` lines, or `--json` for the
machine-readable document CI consumes. Exit 0 = clean, 1 = findings,
2 = usage error. Files named `*_pb2*.py` (generated) are skipped.

The port's copy of seaweedfs_tpu/devtools/swtpu_lint.py, rules and output
unchanged; with no paths it lints the seaweedfs_tpu_torch package:
``python -m seaweedfs_tpu_torch.devtools.swtpu_lint seaweedfs_tpu_torch``.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import re
import sys
from dataclasses import asdict, dataclass

RULES: dict[str, str] = {
    "async-blocking": "blocking call inside `async def` body",
    "io-under-lock": "I/O or cross-node RPC inside a `with <lock>:` block",
    "wallclock-duration": "time.time() used for a duration/deadline "
                          "(use time.monotonic())",
    "silent-except": "broad except whose body swallows silently "
                     "(no log/journal/fallback)",
    "thread-no-join": "non-daemon Thread with no join on any stop path",
    "md5-fips": "hashlib.md5 without usedforsecurity=False",
    "executor-no-context": "executor hop without contextvars.copy_context()",
    "pread-under-lock": "blocking os.pread inside a `with <lock>:` block "
                        "(the lock-free read path must not serialize "
                        "behind writers)",
    "ack-before-fsync": "ack/response call between a write and the fsync "
                        "of the same fd (the ack stands on page cache)",
    "rename-no-dir-fsync": "os.rename/os.replace with no later directory "
                           "fsync in the function (the rename itself can "
                           "be lost in a crash)",
    "vif-write-bypass": ".vif opened for writing outside ec/files.py "
                        "(use write_vif/update_vif)",
    "parse-error": "file does not parse",
}

_SUPPRESS_RE = re.compile(r"#\s*swtpu-lint:\s*disable=([\w\-, ]+)")
# `with <expr>:` counts as a critical section when the final identifier
# reads like a lock (matches self._lock, loc.lock, vol_lock,
# _breakers_lock, self._locks_guard, self._cond, _lock_for(key), ...)
_LOCK_NAME_RE = re.compile(r"(?i)(lock|mutex|guard|cond)s?(_for)?$")
_POOL_NAME_RE = re.compile(r"(?i)(pool|executor|tpe)$")

_SLEEP_CALLS = {"time.sleep"}
_SUBPROCESS_CALLS = {
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output", "subprocess.Popen", "subprocess.getoutput",
    "subprocess.getstatusoutput", "os.system", "os.popen",
}
# sync network I/O: stdlib + requests + this repo's pooled HTTP client
# (client/http_util) + the retry envelope that wraps cross-node RPCs
_NET_CALLS = {
    "requests.get", "requests.post", "requests.put", "requests.delete",
    "requests.head", "requests.request", "requests.Session",
    "urllib.request.urlopen", "urlopen",
    "socket.create_connection", "socket.getaddrinfo",
    "socket.gethostbyname",
    "http_util.get", "http_util.post", "http_util.delete",
    "http_util.request",
    "retry.retry_call", "retry_call",
}
_FILE_CALLS = {"open", "io.open"}
# positioned reads: the seqlock GET path's primitive. Local file I/O in
# general is allowed under per-volume locks (see io-under-lock), but a
# pread specifically marks a LOCK-FREE read path — one issued while
# holding a lock means reads re-serialize behind writers again.
_PREAD_CALLS = {"os.pread", "os.preadv"}
# callee names that acknowledge data to a client/peer. Deliberately a
# closed list of explicit ack verbs: a generic name ("send", "reply_to")
# would drown the rule in false positives, and this codebase's ack
# surfaces (needle PUT, raft commit, filer meta) all go through helpers
# that can adopt one of these names.
_ACK_NAMES = {
    "ack", "send_ack", "send_response", "write_response", "respond",
    "reply", "send_reply", "ack_frame", "mark_acked",
}
# callee names that fsync a *directory* (making a rename durable):
# utils/fsutil.fsync_dir and module-local `_fsync_dir` helpers
_DIRFSYNC_RE = re.compile(r"(?:^|_)(?:fsync_dir|dir_fsync)$")
# identifier that names a .vif sidecar path (`vif_path`, `self.vif`, ...)
_VIF_NAME_RE = re.compile(r"(?i)(?:^|_)vif(?:_path)?$")


@dataclass
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: " \
               f"{self.message}"


def _dotted(node: ast.AST) -> str | None:
    """`a.b.c` -> "a.b.c" for Name/Attribute chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _final_id(node: ast.AST) -> str:
    """Last identifier of an expression (lock-name heuristics)."""
    if isinstance(node, ast.Call):
        return _final_id(node.func)
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _mentions(node: ast.AST, *names: str) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id in names:
            return True
        if isinstance(sub, ast.Attribute) and sub.attr in names:
            return True
    return False


class _FileLinter(ast.NodeVisitor):
    def __init__(self, path: str, tree: ast.Module):
        self.path = path
        self.tree = tree
        self.findings: list[Finding] = []
        # import-alias normalization: {"_time": "time", "rq": "requests"}
        self.aliases: dict[str, str] = {}
        # bare names bound by `from X import y [as z]`: {"z": "X.y"}
        self.from_imports: dict[str, str] = {}
        self._async_depth = 0
        self._fn_stack: list[bool] = []     # is-async per enclosing def
        self._lock_stack: list[str] = []    # lock names currently held
        # per-scope names assigned directly from time.time()
        self._wallclock_names: list[dict[str, ast.AST]] = [{}]
        self._flagged: set[tuple[int, str]] = set()
        # thread lifecycle bookkeeping (module-wide, resolved in finish())
        self._thread_creates: list[tuple[ast.Call, str | None, bool]] = []
        self._joined: set[str] = set()
        self._stored: set[str] = set()
        # per-function durability-ordering events, resolved on fn exit:
        # frames of (line, kind, key, node) where kind is one of
        # write/fsync/ack/rename/dirfsync and key is the fd identifier
        # (write/fsync), the callee name (ack/dirfsync), or the
        # normalized os.rename/os.replace name (rename)
        self._dur_stack: list[list[tuple[int, str, str, ast.Call]]] = []
        self._parents: dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[child] = parent

    # -- plumbing ------------------------------------------------------------
    def _emit(self, node: ast.AST, rule: str, message: str) -> None:
        key = (node.lineno, rule)
        if key in self._flagged:
            return
        self._flagged.add(key)
        self.findings.append(Finding(self.path, node.lineno,
                                     node.col_offset, rule, message))

    def _norm(self, dotted: str | None) -> str | None:
        """Resolve import aliases: `_time.sleep` -> `time.sleep`,
        `urlopen` (from urllib.request import urlopen) -> full path."""
        if dotted is None:
            return None
        head, _, rest = dotted.partition(".")
        if head in self.from_imports:
            head = self.from_imports[head]
        elif head in self.aliases:
            head = self.aliases[head]
        return f"{head}.{rest}" if rest else head

    # -- imports -------------------------------------------------------------
    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            self.aliases[a.asname or a.name] = a.name
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        for a in node.names:
            if node.module:
                self.from_imports[a.asname or a.name] = \
                    f"{node.module}.{a.name}"
        self.generic_visit(node)

    # -- function / lock context ---------------------------------------------
    def _visit_fn(self, node, is_async: bool) -> None:
        self._fn_stack.append(is_async)
        self._async_depth += 1 if is_async else 0
        # a nested def's body does not run inside the enclosing with-lock
        saved_locks, self._lock_stack = self._lock_stack, []
        self._wallclock_names.append({})
        self._dur_stack.append([])
        self.generic_visit(node)
        self._resolve_durability(self._dur_stack.pop())
        self._wallclock_names.pop()
        self._lock_stack = saved_locks
        self._async_depth -= 1 if is_async else 0
        self._fn_stack.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._visit_fn(node, is_async=False)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._visit_fn(node, is_async=True)

    def visit_With(self, node: ast.With) -> None:
        held = [item.context_expr for item in node.items
                if _LOCK_NAME_RE.search(_final_id(item.context_expr) or "")]
        names = [_final_id(e) for e in held]
        self._lock_stack.extend(names)
        self.generic_visit(node)
        del self._lock_stack[len(self._lock_stack) - len(names):]

    # -- calls ---------------------------------------------------------------
    def _in_async(self) -> bool:
        return bool(self._fn_stack) and self._fn_stack[-1]

    def _is_stub_rpc(self, node: ast.Call) -> bool:
        """Stub(addr, SVC).call(...) / <x>stub.call(...): cross-node RPC."""
        f = node.func
        if not (isinstance(f, ast.Attribute) and f.attr == "call"):
            return False
        recv = f.value
        if isinstance(recv, ast.Call) and _final_id(recv.func) == "Stub":
            return True
        return "stub" in _final_id(recv).lower()

    def visit_Call(self, node: ast.Call) -> None:
        name = self._norm(_dotted(node.func))
        blocking_kind = None
        if name in _SLEEP_CALLS:
            blocking_kind = "sleep"
        elif name in _SUBPROCESS_CALLS:
            blocking_kind = "subprocess"
        elif name in _NET_CALLS:
            blocking_kind = "sync network I/O"
        elif self._is_stub_rpc(node):
            blocking_kind = "cross-node RPC"

        if self._in_async():
            kind = blocking_kind
            if kind is None and name in _FILE_CALLS:
                kind = "file I/O"
            if kind is not None:
                self._emit(node, "async-blocking",
                           f"{kind} ({name or 'Stub().call'}) blocks the "
                           "event loop inside `async def`; await an async "
                           "equivalent or offload to a thread")
        if blocking_kind is not None and self._lock_stack:
            self._emit(node, "io-under-lock",
                       f"{blocking_kind} ({name or 'Stub().call'}) while "
                       f"holding {self._lock_stack[-1]!r}; narrow the "
                       "critical section to the shared-state mutation")
        if name in _PREAD_CALLS and self._lock_stack:
            self._emit(node, "pread-under-lock",
                       f"{name} while holding {self._lock_stack[-1]!r}; "
                       "the seqlock read protocol preads OUTSIDE the "
                       "volume lock (resolve, pread, post-validate) so "
                       "reads never queue behind an fsync")

        if name == "hashlib.md5" and not any(
                kw.arg == "usedforsecurity" for kw in node.keywords):
            self._emit(node, "md5-fips",
                       "hashlib.md5() raises on FIPS kernels; pass "
                       "usedforsecurity=False for non-security digests")

        self._check_executor_hop(node, name)
        self._check_thread_create(node, name)
        self._check_wallclock_call(node)
        self._check_durability(node, name)
        self._check_vif_write(node, name)
        self.generic_visit(node)

    def _check_executor_hop(self, node: ast.Call, name: str | None) -> None:
        f = node.func
        if not isinstance(f, ast.Attribute):
            return
        if f.attr == "run_in_executor":
            args = node.args[1:]  # args[0] is the executor (often None)
        elif (f.attr == "submit"
              and _POOL_NAME_RE.search(_final_id(f.value) or "")):
            args = node.args
        else:
            return
        if any(_mentions(a, "copy_context", "run") for a in args):
            return
        self._emit(node, "executor-no-context",
                   f"{f.attr}() drops contextvars (the active trace "
                   "span); wrap the callable with "
                   "contextvars.copy_context().run")

    # -- durability ordering ---------------------------------------------------
    @staticmethod
    def _fd_key(arg: ast.AST) -> str:
        """Identifier behind an fd expression: `f.fileno()` and `f` both
        key as "f" so `os.fsync(f.fileno())` matches `f.write(...)`."""
        if (isinstance(arg, ast.Call) and isinstance(arg.func, ast.Attribute)
                and arg.func.attr == "fileno"):
            return _final_id(arg.func.value)
        return _final_id(arg)

    def _check_durability(self, node: ast.Call, name: str | None) -> None:
        if not self._dur_stack:
            return
        ev = self._dur_stack[-1]
        fid = _final_id(node.func)
        if name in ("os.write", "os.pwrite") and node.args:
            ev.append((node.lineno, "write", self._fd_key(node.args[0]),
                       node))
        elif (fid == "write" and isinstance(node.func, ast.Attribute)):
            key = _final_id(node.func.value)
            if key:
                ev.append((node.lineno, "write", key, node))
        elif name in ("os.fsync", "os.fdatasync") and node.args:
            ev.append((node.lineno, "fsync", self._fd_key(node.args[0]),
                       node))
        elif fid in _ACK_NAMES:
            ev.append((node.lineno, "ack", fid, node))
        if name in ("os.rename", "os.replace"):
            ev.append((node.lineno, "rename", name, node))
        elif _DIRFSYNC_RE.search(fid):
            ev.append((node.lineno, "dirfsync", fid, node))

    def _resolve_durability(
            self, events: list[tuple[int, str, str, ast.Call]]) -> None:
        # ack-before-fsync: ack strictly between write(K) and fsync(K)
        first_write: dict[str, int] = {}
        for line, kind, key, _ in events:
            if kind == "write" and key and key not in first_write:
                first_write[key] = line
        for line, kind, key, _ in events:
            if kind != "fsync" or not key:
                continue
            w = first_write.get(key)
            if w is None or w >= line:
                continue
            for aline, akind, aname, anode in events:
                if akind == "ack" and w < aline < line:
                    self._emit(anode, "ack-before-fsync",
                               f"{aname}() acknowledges data written to "
                               f"{key!r} (line {w}) before its fsync "
                               f"(line {line}); a crash in between loses "
                               "acked bytes — ack after the fsync (the "
                               "crashsim mutant scenario demonstrates "
                               "the loss)")
        # rename-no-dir-fsync: every rename needs a later dir fsync
        last_dirfsync = max(
            (line for line, kind, _, _ in events if kind == "dirfsync"),
            default=-1)
        for line, kind, key, node in events:
            if kind == "rename" and line > last_dirfsync:
                self._emit(node, "rename-no-dir-fsync",
                           f"{key} with no later fsync_dir() in this "
                           "function; the rename is only durable once the "
                           "parent directory is fsynced — call "
                           "utils/fsutil.fsync_dir(dst) after it")

    def _check_vif_write(self, node: ast.Call, name: str | None) -> None:
        if self.path.replace(os.sep, "/").endswith("ec/files.py"):
            return  # the sanctioned writer (write_vif/update_vif)
        if name in _FILE_CALLS:
            mode = None
            if len(node.args) > 1 and isinstance(node.args[1], ast.Constant):
                mode = node.args[1].value
            for kw in node.keywords:
                if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
                    mode = kw.value.value
            if not (isinstance(mode, str)
                    and any(c in mode for c in "wax+")):
                return
        elif name == "os.open":
            if len(node.args) < 2 or not _mentions(
                    node.args[1], "O_WRONLY", "O_RDWR"):
                return
        else:
            return
        if node.args and self._mentions_vif(node.args[0]):
            self._emit(node, "vif-write-bypass",
                       ".vif sidecar opened for writing; go through "
                       "ec/files.write_vif/update_vif (atomic tmp + fsync "
                       "+ rename under the sidecar lock) so a crash can "
                       "never leave a torn sidecar")

    @staticmethod
    def _mentions_vif(node: ast.AST) -> bool:
        for sub in ast.walk(node):
            if (isinstance(sub, ast.Constant)
                    and isinstance(sub.value, str)
                    and ".vif" in sub.value):
                return True
            if isinstance(sub, ast.Name) and _VIF_NAME_RE.search(sub.id):
                return True
            if (isinstance(sub, ast.Attribute)
                    and _VIF_NAME_RE.search(sub.attr)):
                return True
        return False

    def _check_thread_create(self, node: ast.Call, name: str | None) -> None:
        if name not in ("threading.Thread", "threading.Timer"):
            return
        daemon = any(kw.arg == "daemon"
                     and isinstance(kw.value, ast.Constant)
                     and kw.value.value is True for kw in node.keywords)
        target = None
        # walk out of comprehensions/literals: `ts = [Thread(...) for ...]`
        # assigns the CONTAINER name, which is what join loops iterate
        parent = self._parents.get(node)
        while isinstance(parent, (ast.ListComp, ast.SetComp,
                                  ast.GeneratorExp, ast.List, ast.Tuple,
                                  ast.comprehension)):
            parent = self._parents.get(parent)
        if isinstance(parent, ast.Assign) and len(parent.targets) == 1:
            target = _final_id(parent.targets[0]) or None
        elif isinstance(parent, ast.Call) and isinstance(
                parent.func, ast.Attribute) and parent.func.attr in (
                    "append", "add", "put"):
            # handed to a container: assume its owner joins the batch
            self._stored.add("")
            target = ""
        self._thread_creates.append((node, target, daemon))

    # -- wall-clock durations -------------------------------------------------
    def _is_time_call(self, node: ast.AST) -> bool:
        return (isinstance(node, ast.Call)
                and self._norm(_dotted(node.func)) in ("time.time",
                                                       "time.time_ns"))

    def _check_wallclock_call(self, node: ast.Call) -> None:
        if not self._is_time_call(node):
            return
        parent = self._parents.get(node)
        flagged = False
        if isinstance(parent, ast.BinOp) and isinstance(
                parent.op, (ast.Sub, ast.Add)):
            # `time.time() - t0` (elapsed) or `time.time() + n` (deadline);
            # `int(time.time() * 1000)` timestamps have Mult parents and
            # pass untouched
            flagged = True
        elif isinstance(parent, ast.Compare):
            flagged = True
        if flagged:
            self._emit(node, "wallclock-duration",
                       "duration/deadline arithmetic on time.time(); an "
                       "NTP step stalls or fires it — use time.monotonic()")

    def visit_Assign(self, node: ast.Assign) -> None:
        if self._is_time_call(node.value) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            self._wallclock_names[-1][node.targets[0].id] = node
        self.generic_visit(node)

    def visit_BinOp(self, node: ast.BinOp) -> None:
        if isinstance(node.op, ast.Sub):
            self._flag_wallclock_names(node)
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare) -> None:
        self._flag_wallclock_names(node)
        self.generic_visit(node)

    def _flag_wallclock_names(self, expr: ast.AST) -> None:
        """`now = time.time()` ... `now - started > x`: flag the ASSIGN
        line (the conversion site), found through same-scope dataflow."""
        for sub in ast.walk(expr):
            if not isinstance(sub, ast.Name):
                continue
            for scope in self._wallclock_names:
                assign = scope.get(sub.id)
                if assign is not None:
                    self._emit(assign, "wallclock-duration",
                               f"{sub.id!r} holds time.time() but is used "
                               "in duration arithmetic — use "
                               "time.monotonic()")

    # -- silent except --------------------------------------------------------
    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        broad = node.type is None or (
            isinstance(node.type, ast.Name)
            and node.type.id in ("Exception", "BaseException"))
        if broad and all(
                isinstance(st, ast.Pass)
                or (isinstance(st, ast.Expr)
                    and isinstance(st.value, ast.Constant))
                for st in node.body):
            self._emit(node, "silent-except",
                       "broad except swallows the fault with no log/"
                       "journal call; log it, journal it, or suppress "
                       "with a reason")
        self.generic_visit(node)

    # -- module-level resolution ----------------------------------------------
    def finish(self) -> None:
        daemon_attrs: set[str] = set()   # `t.daemon = True` post-creation
        loop_alias: dict[str, str] = {}  # loop var -> iterated container
        for sub in ast.walk(self.tree):
            if isinstance(sub, ast.Call) and isinstance(
                    sub.func, ast.Attribute) and sub.func.attr == "join":
                self._joined.add(_final_id(sub.func.value))
            elif isinstance(sub, ast.Assign) and len(sub.targets) == 1 \
                    and isinstance(sub.targets[0], ast.Attribute) \
                    and sub.targets[0].attr == "daemon" \
                    and isinstance(sub.value, ast.Constant) \
                    and sub.value.value is True:
                daemon_attrs.add(_final_id(sub.targets[0].value))
            elif isinstance(sub, ast.For) and isinstance(
                    sub.target, ast.Name):
                loop_alias[sub.target.id] = _final_id(sub.iter)
        # `for t in threads: t.join()` joins the container the comprehension
        # assigned, not just the loop variable
        for var, container in loop_alias.items():
            if var in self._joined:
                self._joined.add(container)
        for node, target, daemon in self._thread_creates:
            if daemon or (target is not None and target in daemon_attrs):
                continue
            if target == "" or (target is not None
                                and target in self._joined):
                continue
            self._emit(node, "thread-no-join",
                       "non-daemon Thread is never joined in this file; "
                       "join it on the owner's stop path or mark "
                       "daemon=True")

    def run(self) -> list[Finding]:
        self.visit(self.tree)
        self.finish()
        return self.findings


def _suppressed_rules(line: str) -> set[str]:
    m = _SUPPRESS_RE.search(line)
    if not m:
        return set()
    return {r.strip() for r in m.group(1).split(",") if r.strip()}


def lint_file(path: str, display_path: str | None = None) -> list[Finding]:
    display = display_path or path
    try:
        with open(path, encoding="utf-8") as f:
            source = f.read()
    except OSError as e:
        return [Finding(display, 0, 0, "parse-error", str(e))]
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(display, e.lineno or 0, e.offset or 0,
                        "parse-error", e.msg or "syntax error")]
    findings = _FileLinter(display, tree).run()
    lines = source.split("\n")
    kept = []
    for f in findings:
        line = lines[f.line - 1] if 0 < f.line <= len(lines) else ""
        rules = _suppressed_rules(line)
        if f.rule in rules or "all" in rules:
            continue
        kept.append(f)
    return kept


def _iter_py_files(paths: list[str]):
    for p in paths:
        if os.path.isfile(p):
            yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs if d != "__pycache__")
            for name in sorted(files):
                if not name.endswith(".py"):
                    continue
                if "_pb2" in name:  # generated protobuf modules
                    continue
                yield os.path.join(root, name)


def lint_paths(paths: list[str],
               select: "set[str] | None" = None) -> tuple[list[Finding], int]:
    findings: list[Finding] = []
    nfiles = 0
    for path in _iter_py_files(paths):
        nfiles += 1
        for f in lint_file(path):
            if select is None or f.rule in select:
                findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings, nfiles


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(
        prog="swtpu-lint",
        description="AST lint for this repo's concurrency bug classes")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: the "
                         "seaweedfs_tpu_torch package)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    ap.add_argument("--select", default="",
                    help="comma-separated rule subset to report")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)
    if args.list_rules:
        for rule, doc in RULES.items():
            print(f"{rule:22s} {doc}")
        return 0
    select = None
    if args.select:
        select = {r.strip() for r in args.select.split(",") if r.strip()}
        unknown = select - set(RULES)
        if unknown:
            print(f"unknown rule(s): {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2
    paths = args.paths or [os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))]
    findings, nfiles = lint_paths(paths, select)
    if args.as_json:
        print(json.dumps({
            "version": 1,
            "files": nfiles,
            "count": len(findings),
            "findings": [asdict(f) for f in findings],
        }, indent=1))
    else:
        for f in findings:
            print(f.render())
        print(f"swtpu-lint: {len(findings)} finding(s) in {nfiles} "
              f"file(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
