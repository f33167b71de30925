"""Admin shell: command registry + CommandEnv (reference weed/shell).

`CommandEnv` wraps a MasterClient plus the exclusive cluster lock
(command_lock_unlock.go; `confirmIsLocked` gates mutating commands, e.g.
command_ec_encode.go:76). Commands are registered in a table like
shell/commands.go and exposed through the CLI REPL (weed shell).

The port's copy of seaweedfs_tpu/shell/commands.py. Port-only:
`CommandEnv.should_stop`, a callable the admin cron sets to "this master
is no longer the leader"; the long lines (`ec.encode`, the lifecycle
executor) check it between volumes through `deposed(env)` and stop there,
where the reference finishes the line a deposed leader started.
"""

from __future__ import annotations

import shlex
import time
from dataclasses import dataclass, field
from typing import Callable, TextIO

from ..client.master_client import MasterClient
from ..pb import master_pb2 as mpb
from ..utils.rpc import MASTER_SERVICE, Stub

COMMANDS: dict[str, "Command"] = {}


def deposed(env) -> bool:
    """True when the env's owner asks a long line to stop between volumes
    (the cron of a master that lost its leadership)."""
    stop = getattr(env, "should_stop", None)
    return bool(stop is not None and stop())


@dataclass
class Command:
    name: str
    help: str
    fn: Callable
    needs_lock: bool = False


def command(name: str, help: str, needs_lock: bool = False,
            aliases: tuple = ()):
    """`aliases` carries the reference's exact Name() spellings (e.g.
    volumeServer.evacuate) so migrating operators find them; registered
    at import time alongside the canonical name."""
    def deco(fn):
        COMMANDS[name] = Command(name, help, fn, needs_lock)
        for a in aliases:
            COMMANDS[a] = Command(a, f"alias of {name}", fn, needs_lock)
        return fn
    return deco


@dataclass
class CommandEnv:
    master_address: str
    mc: MasterClient = None
    lock_token: int = 0
    lock_time: int = 0
    out: TextIO = None
    option: dict = field(default_factory=dict)
    should_stop: "Callable[[], bool] | None" = None

    def __post_init__(self):
        if self.mc is None:
            self.mc = MasterClient(self.master_address, client_type="shell")
        if self.out is None:
            import sys
            self.out = sys.stdout

    def println(self, *args) -> None:
        print(*args, file=self.out)

    # -- exclusive lock (reference command_lock_unlock.go) ------------------
    def acquire_lock(self) -> None:
        stub = Stub(self.mc.leader, MASTER_SERVICE)
        resp = stub.call("LeaseAdminToken", mpb.LeaseAdminTokenRequest(
            previous_token=self.lock_token, previous_lock_time=self.lock_time,
            lock_name="admin", client_name="shell"),
            mpb.LeaseAdminTokenResponse)
        self.lock_token, self.lock_time = resp.token, resp.lock_ts_ns

    def release_lock(self) -> None:
        if not self.lock_token:
            return
        stub = Stub(self.mc.leader, MASTER_SERVICE)
        stub.call("ReleaseAdminToken", mpb.ReleaseAdminTokenRequest(
            previous_token=self.lock_token, previous_lock_time=self.lock_time,
            lock_name="admin"), mpb.ReleaseAdminTokenResponse)
        self.lock_token = 0

    def confirm_is_locked(self) -> None:
        if not self.lock_token:
            raise RuntimeError(
                "this command requires the exclusive cluster lock; run 'lock' first")

    # -- helpers shared by commands -----------------------------------------
    def topology(self) -> mpb.TopologyInfo:
        return self.mc.volume_list().topology_info

    def collect_volume_servers(self) -> list[dict]:
        out = []
        for dc in self.topology().data_center_infos:
            for rack in dc.rack_infos:
                for node in rack.data_node_infos:
                    out.append({"id": node.id, "grpc_port": node.grpc_port,
                                "dc": dc.id, "rack": rack.id,
                                "disks": node.disk_infos})
        return out

    def grpc_addr(self, node_id: str, grpc_port: int) -> str:
        return f"{node_id.rsplit(':', 1)[0]}:{grpc_port}"


def run_command(env: CommandEnv, line: str) -> bool:
    """Parse and run one shell line. Returns False on 'exit'."""
    parts = shlex.split(line.strip())
    if not parts:
        return True
    name, args = parts[0], parts[1:]
    if name in ("exit", "quit"):
        return False
    if name == "help":
        for c in sorted(COMMANDS.values(), key=lambda c: c.name):
            env.println(f"  {c.name:32s} {c.help}")
        return True
    cmd = COMMANDS.get(name)
    if cmd is None:
        env.println(f"unknown command {name!r}; try 'help'")
        return True
    if cmd.needs_lock:
        env.confirm_is_locked()
    t0 = time.monotonic()
    cmd.fn(env, args)
    if env.option.get("timing"):
        env.println(f"({time.monotonic() - t0:.2f}s)")
    return True


def repl(env: CommandEnv) -> None:
    env.println(f"swtpu shell connected to {env.master_address}; 'help' lists commands")
    while True:
        try:
            line = input("> ")
        except EOFError:
            break
        try:
            if not run_command(env, line):
                break
        except Exception as e:  # noqa: BLE001
            env.println(f"error: {e}")
    env.release_lock()



def list_cluster_nodes(env: "CommandEnv", client_type: str) -> list:
    """Live nodes of a type from the master cluster list (cluster.go:104),
    oldest first; [] on any error. THE single ListClusterNodes call site
    for shell helpers so fixes (grpc ports, retries) land once."""
    from ..pb import master_pb2 as mpb
    from ..utils.rpc import MASTER_SERVICE
    try:
        resp = Stub(env.mc.leader, MASTER_SERVICE).call(
            "ListClusterNodes",
            mpb.ListClusterNodesRequest(client_type=client_type),
            mpb.ListClusterNodesResponse)
        return sorted(resp.cluster_nodes, key=lambda n: n.created_at_ns)
    except Exception:  # noqa: BLE001
        return []


def discover_cluster_node(env: "CommandEnv", client_type: str
                          ) -> "tuple[str, int]":
    """Oldest live node of a type: ('', 0) if none."""
    try:
        nodes = list_cluster_nodes(env, client_type)
        if nodes:
            return nodes[0].address, nodes[0].grpc_port
    except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (no such node type yet; caller reports)
        pass
    return "", 0
