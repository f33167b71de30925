"""The system under test as its users run it: one master and one volume
server a rack, each its own process started with the program's own verbs
(`python -m seaweedfs_tpu_torch master|volume`), on localhost ports."""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
import urllib.request
from dataclasses import dataclass

from . import ports

PROGRAM = "seaweedfs_tpu_torch"


@dataclass
class Server:
    rack: str
    dir: str
    http: str
    grpc: str
    proc: subprocess.Popen
    log: str

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None


def http_get(url: str, timeout: float = 30.0) -> "tuple[int, bytes]":
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def tail(path: str, n: int = 3000) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - n))
            return f.read().decode(errors="replace")
    except OSError:
        return ""


class Cluster:
    """Processes of one run. `entry` is the module the daemons start from:
    the program itself, or a fault-planting wrapper of it in the
    benchmark's own tests."""

    def __init__(self, root: str, workdir: str, geometry: "tuple[int, int]",
                 device: str, env: dict, entry: "list[str] | None" = None):
        self.root = root
        self.workdir = workdir
        self.d, self.p = geometry
        self.device = device
        self.env = env
        self.entry = entry or ["-m", PROGRAM]
        self.master = ""
        self.master_proc: "subprocess.Popen | None" = None
        self.servers: "list[Server]" = []
        self.others: "list[subprocess.Popen]" = []  # e.g. the load process
        os.makedirs(os.path.join(workdir, "logs"), exist_ok=True)

    def _spawn(self, name: str, args: "list[str]", env: dict
               ) -> "tuple[subprocess.Popen, str]":
        log = os.path.join(self.workdir, "logs", f"{name}.log")
        with open(log, "wb") as out:
            proc = subprocess.Popen([sys.executable, *self.entry, *args],
                                    cwd=self.root, env=env, stdout=out,
                                    stderr=subprocess.STDOUT,
                                    stdin=subprocess.DEVNULL)
        return proc, log

    def start_master(self) -> None:
        port = ports.free_port()
        # the admin cron keeps the reference's full first interval (17
        # minutes): no repair sweep starts inside a run
        env = dict(self.env, SWTPU_CRON_INITIAL_DELAY_S="0")
        self.master_proc, self.master_log = self._spawn(
            "master", ["master", "-ip", "127.0.0.1", "-port", str(port),
                       "-ecShards", f"{self.d},{self.p}"], env)
        self.master = f"127.0.0.1:{port}"

    def start_volume(self, rack: str, dirname: str) -> Server:
        port, grpc = ports.free_port(), ports.free_port()
        proc, log = self._spawn(
            f"volume-{rack}",
            ["volume", "-ip", "127.0.0.1", "-port", str(port),
             "-grpcPort", str(grpc), "-mserver", self.master,
             "-dir", dirname, "-max", "16", "-dataCenter", "dc1",
             "-rack", rack, "-device", self.device,
             "-ecShards", f"{self.d},{self.p}"], self.env)
        srv = Server(rack, dirname, f"127.0.0.1:{port}", f"127.0.0.1:{grpc}",
                     proc, log)
        self.servers.append(srv)
        return srv

    def live(self) -> "list[Server]":
        return [s for s in self.servers if s.alive]

    def check_alive(self) -> None:
        if self.master_proc is not None and self.master_proc.poll() is not None:
            raise RuntimeError("the master exited:\n" + tail(self.master_log))
        for s in self.servers:
            if s.proc.poll() is not None and not getattr(s, "stopped", False):
                raise RuntimeError(f"volume server {s.rack} exited "
                                   f"({s.proc.returncode}):\n{tail(s.log)}")

    def wait(self, cond, timeout: float, what: str) -> None:
        deadline = time.monotonic() + timeout
        last: "Exception | None" = None
        while time.monotonic() < deadline:
            self.check_alive()
            try:
                if cond():
                    return
            except Exception as e:  # noqa: BLE001 — not up yet; retried
                last = e
            time.sleep(0.1)
        raise TimeoutError(f"{what} not within {timeout} s (last: {last})")

    def peers(self):
        from seaweedfs_tpu_torch.server.grpc_service import GrpcPeers
        return GrpcPeers(self.master)

    def stop(self, srv: Server, timeout: float = 30.0) -> None:
        srv.stopped = True
        if srv.proc.poll() is None:
            srv.proc.send_signal(signal.SIGTERM)
            try:
                srv.proc.wait(timeout)
            except subprocess.TimeoutExpired:
                srv.proc.kill()
                srv.proc.wait(10)

    def close(self) -> None:
        procs = [s.proc for s in self.servers] + self.others
        if self.master_proc is not None:
            procs.append(self.master_proc)
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + 30
        for p in procs:
            try:
                p.wait(max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(10)

    def cpu_seconds(self) -> "dict[str, float]":
        """User + system CPU seconds each live daemon has used so far."""
        tick = os.sysconf("SC_CLK_TCK")
        out = {}
        procs = [(s.rack, s.proc) for s in self.live()]
        if self.master_proc is not None:
            procs.append(("master", self.master_proc))
        for name, p in procs:
            try:
                with open(f"/proc/{p.pid}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
                out[name] = (int(fields[11]) + int(fields[12])) / tick
            except (OSError, IndexError, ValueError):
                continue
        return out

    # -- what the servers expose ------------------------------------------
    def scrape(self) -> "dict[str, str]":
        return {s.rack: http_get(f"http://{s.http}/metrics")[1].decode()
                for s in self.live()}

    def _each_live(self, fn) -> dict:
        """fn(server) on every live server at once; {rack: result}."""
        from concurrent.futures import ThreadPoolExecutor
        live = self.live()
        with ThreadPoolExecutor(max_workers=max(1, len(live))) as pool:
            return dict(zip([s.rack for s in live], pool.map(fn, live)))

    def trace_start(self) -> "dict[str, float]":
        """Start every live server's capture at once; {rack: the monotonic
        time its start request returned}."""
        def start(s: Server) -> float:
            code, body = http_get(f"http://{s.http}/debug/jax-profiler",
                                  timeout=120)
            if code != 200:
                raise RuntimeError(f"profiler start on {s.rack}: {code} "
                                   f"{body[:300]!r}")
            return time.monotonic()
        return self._each_live(start)

    def trace_stop(self) -> "dict[str, str]":
        """Stop every live server's capture at once; {rack: trace path}."""
        def stop(s: Server) -> str:
            code, body = http_get(f"http://{s.http}/debug/jax-profiler?stop=1",
                                  timeout=300)
            if code != 200:
                raise RuntimeError(f"profiler stop on {s.rack}: {code} "
                                   f"{body[:300]!r}")
            return body.decode().strip().rsplit(" ", 1)[-1]
        return self._each_live(stop)


def cpu_groups() -> "list[list[int]]":
    """This process's CPUs grouped by physical core (hyperthread
    siblings together), where the machine says; one CPU a group where it
    does not."""
    mine = sorted(os.sched_getaffinity(0))
    groups: "dict[tuple, list[int]]" = {}
    for cpu in mine:
        try:
            with open(f"/sys/devices/system/cpu/cpu{cpu}/topology/"
                      "thread_siblings_list") as f:
                key = tuple(f.read().strip().split(","))
        except OSError:
            key = ()
        if key in ((), ("",)):
            key = (str(cpu),)
        groups.setdefault(key, []).append(cpu)
    return list(groups.values())


def set_affinity(pid: int, cpus: "list[int]") -> None:
    """Every thread of process `pid` on `cpus` (the threads it makes later
    inherit it)."""
    try:
        tids = [int(t) for t in os.listdir(f"/proc/{pid}/task")]
    except OSError:
        tids = [pid]
    for tid in tids:
        try:
            os.sched_setaffinity(tid, cpus)
        except (ProcessLookupError, PermissionError):
            continue  # a thread that has just ended


def pin(cluster) -> None:
    """Give each live volume server CPUs of its own for the window, as
    each rack's server has a machine of its own in a deployment: whole
    cores while there are enough, single CPUs when not. The master, the
    load and this process share what is left, or every CPU when nothing
    is. Set-up runs before it, on every CPU."""
    groups = cpu_groups()
    serving = cluster.live()
    if len(groups) <= len(serving):
        groups = [[c] for g in groups for c in g]
    if len(groups) <= len(serving):
        return  # fewer CPUs than servers: leave the scheduler to it
    shares = groups[-len(serving):]
    rest = sorted(c for g in groups[:-len(serving)] for c in g)
    for s, cpus in zip(serving, shares):
        set_affinity(s.proc.pid, cpus)
    others = [p.pid for p in cluster.others if p.poll() is None]
    if cluster.master_proc is not None:
        others.append(cluster.master_proc.pid)
    for pid in others + [os.getpid()]:
        set_affinity(pid, rest)


def launch(run) -> None:
    """A directory a rack, the master and a volume server a rack, all
    started at once; run.cluster holds them."""
    from .volumes import rack_names
    cfg = run.cfg
    entry = ["-m", "weedbench.faults", run.fault] if run.fault else None
    c = run.cluster = Cluster(str(run.root), run.workdir,
                              (int(cfg["d"]), int(cfg["p"])), run.device,
                              run.env, entry=entry)
    c.start_master()
    for r in rack_names(cfg):
        os.makedirs(os.path.join(run.workdir, r))
        c.start_volume(r, os.path.join(run.workdir, r))
    run.mark("daemons started")
