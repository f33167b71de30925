"""Crash-state enumerator over the repo's fsync-before-ack surfaces.

ALICE-style application-level crash-consistency checking (the
record/replay half of the crash-consistency plane; the static half is
the `ack-before-fsync` / `rename-no-dir-fsync` / `vif-write-bypass`
rules in swtpu_lint): each scenario runs a real workload — the actual
Volume / EC-encode / raft / MetaLog code, no mocks — under the
utils/fstrack VFS shim, then every legal crash state of the captured
op trace is materialized into a fresh directory and the surface's real
recovery code runs on it, with invariants checked against the
durability promises (`mark("ack", ...)`) the workload made.

Crash-state model (what "legal" means — see utils/fstrack.py and the
README "Crash consistency" section):

* a crash point is chosen after each traced op: later ops never
  happened;
* per file, data ops (create/write/trunc) persist in program order; an
  un-fsynced *suffix* may additionally be dropped, and the last
  surviving write may be torn mid-record (ext4 data=ordered appends);
* `fsync(F)` pins every earlier data op on F, including its creation;
* renames/unlinks are directory metadata: droppable (again suffix-wise
  per directory) unless pinned by a later `fsync_dir` of the parent or
  an `fsync` of the rename's destination — a dropped `os.replace`
  leaves the OLD destination AND the tmp file;
* drops compose across independent files/directories (a seeded sample
  of joint drops is enumerated on top of the exhaustive single-family
  ones);
* states are deduplicated by content hash, so the reported count is
  DISTINCT on-disk states actually recovered.

Scenario matrix (one per durability contract):
  single-put     — Volume.write_needle(sync=) fsync-before-ack
  bulk-frame     — write_needles single-fsync frame ack + torn-frame
                   heal via _check_integrity
  ec-seal        — the streaming encoder (ec/stream.encode_volumes):
                   WriterPool pwrites, then the shard fsyncs before the
                   .ecx and the .vif seal: sealed-vif ⇒ shards+.ecx
                   readable
  raft-commit    — WAL append/commit + compaction snapshot fold:
                   committed entries survive any crash
  vif-stamp      — lifecycle DestroyTime stamp via update_vif:
                   the .vif is always a complete old-or-new JSON

Mutants (`MUTANTS`, excluded from the default matrix) seed known bug
classes to prove the harness catches them; tests assert the
ack-before-fsync mutant trips BOTH this simulator and the lint rule.

CLI: ``python -m seaweedfs_tpu_torch.devtools.crashsim [--artifact F]
[--scenario NAME]... [--seed N] [--max-states N] [--min-states N]
[--device cuda|cpu]`` — exits 1 on any invariant violation (or a total
below --min-states), 2 on an unknown scenario, writing a JSON artifact
with per-scenario states/violations.

The port's copy of seaweedfs_tpu/devtools/crashsim.py: the enumerator,
the harness, the CLI and the recovery checks are the reference's, and the
scenarios run the port's surfaces (storage/volume.Volume, master/raft,
ec/files). Two differences. `ec-seal` encodes through the port's own
streaming encoder, `ec/stream.encode_volumes`, with the port's TorchCoder
(kernel K1 on the card), where the reference's goes through
`ec/encoder.encode_volume` with NumpyCoder: the port's shard files come
from the streaming encoder, so that is the seal to hold. Its coder runs on
`--device` (default "cuda"; with no card it raises, and `--device cpu`
selects the plain PyTorch version). And `meta-log` appends through the
port's filer/meta_log.MetaLog.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import shutil
import sys
import tempfile

from ..utils import fstrack

# violations recorded per scenario before enumeration stops early —
# one is failure already; the rest are diagnosis context
MAX_VIOLATIONS = 20


# ---------------------------------------------------------------------------
# crash-state enumeration
# ---------------------------------------------------------------------------

def _apply(snapshot: dict, ops, dropped: frozenset,
           cut: "tuple[int, int] | None") -> dict:
    """Replay `ops` minus `dropped` seqs over the pre-trace snapshot;
    `cut=(seq, keep)` tears that write to its first `keep` bytes."""
    files = {p: bytearray(b) for p, b in snapshot.items()}
    for op in ops:
        if op.seq in dropped:
            continue
        if op.kind == "create":
            files.setdefault(op.path, bytearray())
        elif op.kind == "write":
            data = op.data
            if cut is not None and cut[0] == op.seq:
                data = data[:cut[1]]
            buf = files.setdefault(op.path, bytearray())
            if len(buf) < op.offset:
                buf.extend(b"\x00" * (op.offset - len(buf)))
            buf[op.offset:op.offset + len(data)] = data
        elif op.kind == "trunc":
            buf = files.setdefault(op.path, bytearray())
            if len(buf) > op.length:
                del buf[op.length:]
            else:
                buf.extend(b"\x00" * (op.length - len(buf)))
        elif op.kind == "rename":
            files[op.dst] = files.pop(op.path, bytearray())
        elif op.kind == "unlink":
            files.pop(op.path, None)
    return files


def _families(prefix):
    """Droppable (un-pinned) op seqs of a prefix, grouped into
    independently-droppable suffix families.

    Returns (families, last_writes): families is a list of seq-lists
    (each in program order; only suffixes of a family may be dropped
    together), last_writes maps path -> the final un-pinned write op
    (tear candidate)."""
    last_fsync: dict = {}      # path -> seq of latest fsync in prefix
    last_dirfsync: dict = {}   # dir  -> seq
    for op in prefix:
        if op.kind == "fsync":
            last_fsync[op.path] = op.seq
        elif op.kind == "fsync_dir":
            last_dirfsync[op.path] = op.seq
    data: dict = {}
    meta: dict = {}
    last_writes: dict = {}
    for op in prefix:
        if op.kind in ("create", "write", "trunc"):
            if op.seq > last_fsync.get(op.path, 0):
                data.setdefault(op.path, []).append(op.seq)
                # a tear is only legal on the FINAL surviving data op
                # of its file (per-file prefix ordering)
                if op.kind == "write" and len(op.data) > 1:
                    last_writes[op.path] = op
                else:
                    last_writes.pop(op.path, None)
            else:
                last_writes.pop(op.path, None)
        elif op.kind in ("rename", "unlink"):
            d = os.path.dirname(op.dst if op.kind == "rename" else op.path)
            pinned = op.seq < last_dirfsync.get(d, 0) or (
                op.kind == "rename"
                and op.seq < last_fsync.get(op.dst, 0))
            if not pinned:
                meta.setdefault(d, []).append(op.seq)
    return list(data.values()) + list(meta.values()), last_writes


def enumerate_states(ops, snapshot, rng,
                     max_states: int = 100000,
                     torn_cuts: int = 2,
                     combo_samples: int = 2):
    """Yield (files, acked_marks, desc) per DISTINCT crash state."""
    real = [op for op in ops if op.kind != "mark"]
    marks = [op for op in ops if op.kind == "mark"]
    seen: set = set()
    emitted = 0

    def _emit(prefix_end, dropped, cut, why):
        nonlocal emitted
        files = _apply(snapshot, real[:prefix_end], dropped, cut)
        digest = hashlib.sha1()
        for p in sorted(files):
            digest.update(p.encode())
            digest.update(b"\x00")
            digest.update(hashlib.sha1(bytes(files[p])).digest())
        key = digest.digest()
        if key in seen:
            return None
        seen.add(key)
        emitted += 1
        last_seq = real[prefix_end - 1].seq if prefix_end else 0
        acked = [m for m in marks if m.seq <= last_seq]
        return files, acked, why

    for i in range(1, len(real) + 1):
        if emitted >= max_states:
            return
        prefix = real[:i]
        at = f"op{prefix[-1].seq}:{prefix[-1].kind}"
        st = _emit(i, frozenset(), None, f"crash after {at}")
        if st:
            yield st
        fams, last_writes = _families(prefix)
        for fam in fams:
            for t in range(1, len(fam) + 1):
                if emitted >= max_states:
                    return
                st = _emit(i, frozenset(fam[-t:]), None,
                           f"crash after {at}, dropped {t} unsynced")
                if st:
                    yield st
        if len(fams) > 1:
            for _ in range(combo_samples):
                drop: set = set()
                for fam in fams:
                    t = rng.randint(0, len(fam))
                    if t:
                        drop.update(fam[-t:])
                if drop and emitted < max_states:
                    st = _emit(i, frozenset(drop), None,
                               f"crash after {at}, joint drop")
                    if st:
                        yield st
        for op in last_writes.values():
            n = len(op.data)
            cuts = {n // 2}
            for _ in range(max(0, torn_cuts - 1)):
                cuts.add(rng.randrange(1, n))
            for c in sorted(cuts):
                if emitted >= max_states:
                    return
                st = _emit(i, frozenset(), (op.seq, c),
                           f"crash after {at}, torn write @{c}")
                if st:
                    yield st


# ---------------------------------------------------------------------------
# harness
# ---------------------------------------------------------------------------

def _snapshot_dir(root: str) -> dict:
    snap = {}
    for dirpath, _dirs, names in os.walk(root):
        for name in names:
            p = os.path.join(dirpath, name)
            with open(p, "rb") as f:
                snap[p] = f.read()
    return snap


def _materialize(files: dict, work: str, sdir: str) -> None:
    for p, content in files.items():
        rel = os.path.relpath(p, work)
        if rel.startswith(".."):
            continue  # outside the workload root (never expected)
        dst = os.path.join(sdir, rel)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        with open(dst, "wb") as f:
            f.write(bytes(content))


def run_scenario(sc, seed: int = 0, max_states: int = 100000) -> dict:
    """Record one scenario, enumerate crash states, run its recovery
    checks on each; returns the per-scenario stats dict."""
    rng = random.Random((seed << 8) ^ len(sc.name))
    res = {"scenario": sc.name, "surface": sc.surface, "ops": 0,
           "states": 0, "violations": []}
    with tempfile.TemporaryDirectory(prefix=f"crashsim-{sc.name}-") as top:
        work = os.path.join(top, "work")
        os.makedirs(work)
        ctx: dict = {}
        sc.setup(work, ctx, rng)
        snapshot = _snapshot_dir(work)
        fresh_install = not fstrack.installed()
        fstrack.install()
        fstrack.start_trace(work)
        try:
            sc.run(work, ctx, rng)
        finally:
            ops = fstrack.stop_trace()
            if fresh_install:
                fstrack.uninstall()
        res["ops"] = sum(1 for op in ops if op.kind != "mark")
        sdir = os.path.join(top, "state")
        for files, acked, desc in enumerate_states(ops, snapshot, rng,
                                                   max_states=max_states):
            res["states"] += 1
            shutil.rmtree(sdir, ignore_errors=True)
            os.makedirs(sdir)
            _materialize(files, work, sdir)
            try:
                errs = sc.check(sdir, ctx, acked)
            except Exception as e:  # noqa: BLE001 — a crashed checker IS a finding
                errs = [f"invariant driver crashed: {e!r}"]
            if errs:
                res["violations"].append({"state": desc,
                                          "errors": errs[:5]})
                if len(res["violations"]) >= MAX_VIOLATIONS:
                    break
    return res


def _sha(b: bytes) -> str:
    return hashlib.sha1(b).hexdigest()


def _acks(acked, label):
    return [m for m in acked if m.label == label]


# ---------------------------------------------------------------------------
# scenarios — one per durability contract
# ---------------------------------------------------------------------------

class _VolumeScenarioBase:
    """Shared volume recovery driver: acked-data-readable +
    no-torn-needle-served through the real Volume open
    (_check_integrity heals the tail before any read)."""

    surface = "volume"

    def check(self, sdir, ctx, acked):
        from ..storage.volume import Volume
        acks = _acks(acked, "ack")
        if not os.path.exists(os.path.join(sdir, "1.dat")):
            return (["acked write but no .dat survived the crash"]
                    if acks else [])
        try:
            v = Volume(sdir, "", 1, create_if_missing=False)
        except Exception as e:  # noqa: BLE001 — per-volume load failure
            # DiskLocation quarantines unloadable volumes (load wraps each
            # in try/except), so a crash mid-creation — before anything
            # was acked — costs nothing. With acks it costs acked data.
            return ([f"volume recovery crashed: {e!r}"] if acks else [])
        errs = []
        try:
            for m in acks:
                k, sha = m.meta["key"], m.meta["sha"]
                try:
                    n = v.read_needle(k, verify_crc=True)
                except Exception as e:  # noqa: BLE001
                    errs.append(f"acked needle {k} unreadable: {e!r}")
                    continue
                if _sha(n.data) != sha:
                    errs.append(f"acked needle {k} corrupt after recovery")
            keys = ctx.get("all_keys", [])
            for k in keys:
                try:
                    v.read_needle(k, verify_crc=True)
                except KeyError:
                    pass  # un-acked needle legitimately lost
                except Exception as e:  # noqa: BLE001
                    errs.append(f"torn needle {k} served: {e!r}")
        finally:
            v.close()
        return errs

    @staticmethod
    def _needle(rng, k):
        from ..storage.needle import Needle
        data = rng.randbytes(rng.randint(48, 220))
        return Needle(id=k, cookie=0x5eed, data=data), _sha(data)


class SinglePutScenario(_VolumeScenarioBase):
    """Alternating sync/async single-needle PUTs; only the sync ones
    are acked, and an un-acked tail rides behind the last fsync."""

    name = "single-put"

    def setup(self, work, ctx, rng):
        ctx["all_keys"] = list(range(1, 13))

    def run(self, work, ctx, rng):
        from ..storage.volume import Volume
        v = Volume(work, "", 1)
        try:
            for k in ctx["all_keys"]:
                n, sha = self._needle(rng, k)
                sync = k % 2 == 1
                v.write_needle(n, sync=sync)
                if sync:
                    fstrack.mark("ack", key=k, sha=sha)
        finally:
            v.close()


class BulkFrameScenario(_VolumeScenarioBase):
    """Two bulk frames: the first fsync'd and acked as a unit, the
    second un-synced — its records are the droppable/torn tail the
    reopen-time heal must truncate away."""

    name = "bulk-frame"

    def setup(self, work, ctx, rng):
        ctx["all_keys"] = list(range(1, 17))

    def run(self, work, ctx, rng):
        from ..storage.volume import Volume
        v = Volume(work, "", 1)
        try:
            frame, shas = [], []
            for k in ctx["all_keys"][:10]:
                n, sha = self._needle(rng, k)
                frame.append(n)
                shas.append((k, sha))
            v.write_needles(frame, sync=True)
            for k, sha in shas:
                fstrack.mark("ack", key=k, sha=sha)
            tail = [self._needle(rng, k)[0] for k in ctx["all_keys"][10:]]
            v.write_needles(tail, sync=False)
        finally:
            v.close()


class EcSealScenario:
    """Streaming EC encode + seal: any state with a readable sealed
    .vif must serve every source needle byte-identical from shards
    alone (the .dat may already be gone after a real seal). The encode
    runs on `device` ("cuda" unless "cpu" is asked for)."""

    name = "ec-seal"
    surface = "ec"

    def __init__(self, device="cuda"):
        self.device = device

    def setup(self, work, ctx, rng):
        from ..storage.volume import Volume
        v = Volume(work, "", 1)
        payloads = {}
        try:
            for k in range(1, 19):
                data = rng.randbytes(rng.randint(60, 300))
                from ..storage.needle import Needle
                v.write_needle(Needle(id=k, cookie=0x5eed, data=data))
                payloads[k] = _sha(data)
            v.sync()
        finally:
            v.close()
        ctx["payloads"] = payloads

    def run(self, work, ctx, rng):
        from ..ec.locate import EcGeometry
        from ..ec.stream import encode_volumes
        from ..ops.coder import TorchCoder
        base = os.path.join(work, "1")
        geo = EcGeometry(d=4, p=2, large_block=1024, small_block=256)
        coder = TorchCoder(geo.d, geo.p, device=self.device)
        encode_volumes([(base + ".dat", base, base + ".idx")], geo, coder,
                       chunk=256, batch=4)
        fstrack.mark("sealed")

    def check(self, sdir, ctx, acked):
        from ..ec import files as ec_files
        from ..ec.volume import EcVolume
        base = os.path.join(sdir, "1")
        if not os.path.exists(base + ".vif"):
            # unsealed: the snapshot .dat is still authoritative
            return []
        try:
            info = ec_files.read_vif(base + ".vif")
        except Exception as e:  # noqa: BLE001
            return [f"torn .vif survived a crash: {e!r}"]
        if "dat_size" not in info:
            return [f"sealed .vif missing geometry: {info}"]
        try:
            ev = EcVolume(base, 1)
        except Exception as e:  # noqa: BLE001
            return [f"sealed volume failed to load: {e!r}"]
        errs = []
        try:
            for k, sha in ctx["payloads"].items():
                try:
                    n = ev.read_needle(k, verify_crc=True)
                except Exception as e:  # noqa: BLE001
                    errs.append(f"sealed needle {k} unreadable from "
                                f"shards: {e!r}")
                    continue
                if _sha(n.data) != sha:
                    errs.append(f"sealed needle {k} corrupt from shards")
        finally:
            ev.close()
        return errs


class RaftCommitScenario:
    """WAL append/commit then a compaction fold then more appends:
    every acked (committed) entry must survive — in the recovered log
    or folded into the recovered snapshot — at any crash point."""

    name = "raft-commit"
    surface = "raft"

    def setup(self, work, ctx, rng):
        ctx["state_path"] = os.path.join("raft", "state.json")

    def _node(self, root, ctx):
        from ..master.raft import RaftNode
        return RaftNode("n1:1", ["n1:1"], lambda _c: None,
                        state_path=os.path.join(root, ctx["state_path"]))

    def run(self, work, ctx, rng):
        from ..master.raft import LogEntry
        node = self._node(work, ctx)
        node.current_term = 1
        cmds = []
        try:
            for k in range(12):
                cmd = {"op": "set", "key": f"k{k}",
                       "val": rng.randint(0, 1 << 30)}
                e = LogEntry(1, cmd)
                node.log.append(e)
                node._wal_append([e])
                idx = node.log_start + len(node.log) - 1
                node.commit_index = idx
                cmds.append(cmd)
                fstrack.mark("commit", index=idx, cmd=cmd)
            node.voted_for = "n1:1"
            node._persist_meta()
            # compaction: fold the first 5 committed entries into the
            # snapshot, exactly like _maybe_compact
            node.snapshot_state = {
                "kv": {c["key"]: c["val"] for c in cmds[:5]}}
            node.snapshot_term = 1
            node.log = node.log[5:]
            node.log_start = 5
            node._persist()
            for k in range(12, 16):
                cmd = {"op": "set", "key": f"k{k}",
                       "val": rng.randint(0, 1 << 30)}
                e = LogEntry(1, cmd)
                node.log.append(e)
                node._wal_append([e])
                idx = node.log_start + len(node.log) - 1
                node.commit_index = idx
                fstrack.mark("commit", index=idx, cmd=cmd)
        finally:
            node.stop()

    def check(self, sdir, ctx, acked):
        try:
            node = self._node(sdir, ctx)
        except Exception as e:  # noqa: BLE001
            return [f"raft recovery crashed: {e!r}"]
        errs = []
        try:
            for m in _acks(acked, "commit"):
                idx, cmd = m.meta["index"], m.meta["cmd"]
                if idx < node.log_start:
                    kv = node.snapshot_state.get("kv", {})
                    if kv.get(cmd["key"]) != cmd["val"]:
                        errs.append(f"committed entry {idx} lost from "
                                    f"the recovered snapshot")
                elif idx <= node._last_index:
                    if node._entry(idx).command != cmd:
                        errs.append(f"committed entry {idx} diverged "
                                    f"after recovery")
                else:
                    errs.append(f"committed entry {idx} missing after "
                                f"recovery")
        finally:
            node.stop()
        return errs


class VifStampScenario:
    """Lifecycle DestroyTime stamp through update_vif: any crash state
    must read back as the COMPLETE old or COMPLETE new sidecar, and an
    acked stamp (update_vif returned) must be the new one."""

    name = "vif-stamp"
    surface = "ec"

    OLD = {"version": 3, "dat_size": 4096, "d": 4, "p": 2,
           "large_block": 1024, "small_block": 256, "codec": "rs"}
    STAMP = 1_700_000_000

    def setup(self, work, ctx, rng):
        from ..ec import files as ec_files
        ec_files.write_vif(os.path.join(work, "1.vif"), **self.OLD)

    def run(self, work, ctx, rng):
        from ..ec import files as ec_files
        ec_files.update_vif(os.path.join(work, "1.vif"),
                            {"destroy_time": self.STAMP})
        fstrack.mark("stamped")

    def check(self, sdir, ctx, acked):
        from ..ec import files as ec_files
        path = os.path.join(sdir, "1.vif")
        if not os.path.exists(path):
            return ["sealed .vif vanished in a crash state"]
        try:
            info = ec_files.read_vif(path)
        except Exception as e:  # noqa: BLE001
            return [f"torn .vif after stamp crash: {e!r}"]
        new = dict(self.OLD, destroy_time=self.STAMP)
        if info != self.OLD and info != new:
            return [f"non-atomic .vif stamp: {info}"]
        if _acks(acked, "stamped") and info != new:
            return ["acked DestroyTime stamp lost after crash"]
        return []


class MetaLogScenario:
    """Filer meta-log appends (flush, no fsync): recovery must read an
    exact PREFIX of the appended events — a torn or dropped tail is
    fine, a gap, phantom or parse crash is not."""

    name = "meta-log"
    surface = "filer"

    def setup(self, work, ctx, rng):
        ctx["names"] = [f"f{k:02d}" for k in range(16)]

    def run(self, work, ctx, rng):
        from ..filer.meta_log import MetaLog
        from ..pb import filer_pb2 as fpb
        ml = MetaLog(os.path.join(work, "filer", "meta.log"))
        try:
            for name in ctx["names"]:
                ev = fpb.EventNotification()
                ev.new_entry.name = name
                ml.append("/d", ev)
        finally:
            ml.close()

    def check(self, sdir, ctx, acked):
        from ..filer.meta_log import MetaLog
        from ..pb import filer_pb2 as fpb
        ml = MetaLog(None)
        ml._path = os.path.join(sdir, "filer", "meta.log")
        try:
            events, _pos = ml._read_persisted(0)
        except Exception as e:  # noqa: BLE001
            return [f"meta-log recovery crashed: {e!r}"]
        names = []
        for _ts, blob in events:
            resp = fpb.SubscribeMetadataResponse()
            try:
                resp.ParseFromString(blob)
            except Exception as e:  # noqa: BLE001
                return [f"meta-log replayed a torn record: {e!r}"]
            names.append(resp.event_notification.new_entry.name)
        if names != ctx["names"][:len(names)]:
            return [f"meta-log replay is not a prefix: {names}"]
        return []


class AckBeforeFsyncMutant(_VolumeScenarioBase):
    """Seeded bug: acks every PUT immediately, fsyncs once at the end —
    the exact ordering inversion the `ack-before-fsync` lint rule
    flags. Every crash point between an ack and the final sync is an
    acked-data-lost violation; tests assert BOTH tools catch it."""

    name = "mutant-ack-before-fsync"

    def setup(self, work, ctx, rng):
        ctx["all_keys"] = list(range(1, 9))

    def run(self, work, ctx, rng):
        from ..storage.volume import Volume
        v = Volume(work, "", 1)
        try:
            for k in ctx["all_keys"]:
                n, sha = self._needle(rng, k)
                v.write_needle(n, sync=False)
                fstrack.mark("ack", key=k, sha=sha)  # BUG: ack precedes fsync
            v.sync()
        finally:
            v.close()


def scenarios(device="cuda") -> list:
    """The default matrix, with ec-seal's coder on `device`."""
    return [SinglePutScenario(), BulkFrameScenario(), EcSealScenario(device),
            RaftCommitScenario(), VifStampScenario(), MetaLogScenario()]


SCENARIOS = scenarios()
MUTANTS = {m.name: m for m in [AckBeforeFsyncMutant()]}


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def run_matrix(names=None, seed: int = 0,
               max_states: int = 100000, device="cuda") -> dict:
    matrix = scenarios(device)
    byname = {s.name: s for s in matrix}
    byname.update(MUTANTS)
    picked = ([byname[n] for n in names] if names
              else matrix)
    out = {"seed": seed, "scenarios": [], "total_states": 0,
           "total_violations": 0}
    for sc in picked:
        res = run_scenario(sc, seed=seed, max_states=max_states)
        out["scenarios"].append(res)
        out["total_states"] += res["states"]
        out["total_violations"] += len(res["violations"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="crashsim", description="crash-state enumerator over the "
        "fsync-before-ack surfaces (see module docstring)")
    ap.add_argument("--scenario", action="append", metavar="NAME",
                    help="run only NAME (repeatable; mutants allowed)")
    ap.add_argument("--seed", type=int,
                    default=int(os.environ.get("SWTPU_CRASHSIM_SEED", "0")))
    ap.add_argument("--max-states", type=int, default=100000,
                    help="cap on distinct states per scenario")
    ap.add_argument("--min-states", type=int, default=0,
                    help="fail if fewer distinct states enumerated in total")
    ap.add_argument("--artifact", metavar="PATH",
                    help="write the JSON report here")
    ap.add_argument("--list", action="store_true",
                    help="list scenarios and mutants, then exit")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where ec-seal's coder runs (no fallback)")
    opt = ap.parse_args(argv)

    if opt.list:
        for sc in SCENARIOS:
            print(f"{sc.name:24s} [{sc.surface}]")
        for name, sc in MUTANTS.items():
            print(f"{name:24s} [{sc.surface}] (mutant)")
        return 0

    try:
        report = run_matrix(opt.scenario, seed=opt.seed,
                            max_states=opt.max_states, device=opt.device)
    except KeyError as e:
        print(f"crashsim: unknown scenario {e}", file=sys.stderr)
        return 2

    for res in report["scenarios"]:
        print(f"crashsim: {res['scenario']:24s} [{res['surface']:6s}] "
              f"{res['ops']:4d} ops -> {res['states']:4d} states, "
              f"{len(res['violations'])} violation(s)")
        for v in res["violations"][:5]:
            print(f"  VIOLATION at {v['state']}:")
            for err in v["errors"]:
                print(f"    - {err}")
    print(f"crashsim: {report['total_states']} distinct crash states, "
          f"{report['total_violations']} violation(s) "
          f"(seed {report['seed']})")

    if opt.artifact:
        with open(opt.artifact, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"crashsim: wrote {opt.artifact}")

    if report["total_violations"]:
        return 1
    if opt.min_states and report["total_states"] < opt.min_states:
        print(f"crashsim: only {report['total_states']} states "
              f"(< --min-states {opt.min_states})", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
