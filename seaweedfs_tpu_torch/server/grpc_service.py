"""The volume server's gRPC binding: the RPCs of the core on the wire, the
network peer plane, and the heartbeat stream to the master.

Counterpart of the gRPC half of seaweedfs_tpu/server/volume_server.py:
`build_service` (its `_build_service`, :2355) turns pb requests into calls
of the core's snake-case methods and their plain results into pb
responses; `GrpcPeers` reaches other volume servers (the port's or the JAX
package's: the service strings are the same) and the master's
LookupEcVolume; `Heartbeater` feeds `VolumeServer.heartbeat()` to the
master's SendHeartbeat stream (`_heartbeat_loop`, :350-423). The core never
imports this module.
"""

from __future__ import annotations

import threading
import time

import grpc

from ..pb import master_pb2 as mpb
from ..pb import volume_server_pb2 as vpb
from ..utils.log import logger
from ..utils.rpc import (MASTER_SERVICE, VOLUME_SERVICE, RpcService, Stub,
                         serve, set_cluster_key)
from .volume_server import RpcAbort, VolumeServer

log = logger("volume_grpc")


_STATUS = {c.value[0]: c for c in grpc.StatusCode}


def _aborting(fn):
    """Turn the core's RpcAbort into a gRPC abort with its status code."""
    def wrapped(req, context):
        try:
            return fn(req)
        except RpcAbort as e:
            context.abort(_STATUS[e.code], e.message)
    return wrapped


def _aborting_stream(fn):
    def wrapped(req, context):
        try:
            yield from fn(req)
        except RpcAbort as e:
            context.abort(_STATUS[e.code], e.message)
    return wrapped


def _aborting_subscription(fn):
    """_aborting_stream for a body that also needs the call's context (to
    stop when the client goes away)."""
    def wrapped(req, context):
        try:
            yield from fn(req, context)
        except RpcAbort as e:
            context.abort(_STATUS[e.code], e.message)
    return wrapped


def build_service(vs: VolumeServer) -> RpcService:
    """The volume service over core `vs`: pb requests in, core methods
    called, pb responses out."""
    svc = RpcService(VOLUME_SERVICE)

    def unary(name, req_cls, resp_cls):
        def deco(fn):
            svc.unary(name, req_cls, resp_cls)(_aborting(fn))
            return fn
        return deco

    def stream(name, req_cls, resp_cls):
        def deco(fn):
            svc.unary_stream(name, req_cls, resp_cls)(_aborting_stream(fn))
            return fn
        return deco

    # -- volume admin ----------------------------------------------------------
    @unary("AllocateVolume", vpb.AllocateVolumeRequest,
           vpb.AllocateVolumeResponse)
    def allocate(req):
        vs.allocate_volume(req.volume_id, req.collection, req.replication,
                           req.ttl, req.disk_type)
        return vpb.AllocateVolumeResponse()

    @unary("VolumeDelete", vpb.VolumeDeleteRequest, vpb.VolumeDeleteResponse)
    def volume_delete(req):
        vs.volume_delete(req.volume_id, req.only_empty)
        return vpb.VolumeDeleteResponse()

    @unary("VolumeMarkReadonly", vpb.VolumeMarkReadonlyRequest,
           vpb.VolumeMarkReadonlyResponse)
    def mark_ro(req):
        vs.volume_mark_readonly(req.volume_id)
        return vpb.VolumeMarkReadonlyResponse()

    @unary("VolumeMarkWritable", vpb.VolumeMarkWritableRequest,
           vpb.VolumeMarkWritableResponse)
    def mark_rw(req):
        vs.volume_mark_writable(req.volume_id)
        return vpb.VolumeMarkWritableResponse()

    @unary("VolumeMount", vpb.VolumeMountRequest, vpb.VolumeMountResponse)
    def volume_mount(req):
        vs.volume_mount(req.volume_id, req.collection)
        return vpb.VolumeMountResponse()

    @unary("VolumeUnmount", vpb.VolumeUnmountRequest,
           vpb.VolumeUnmountResponse)
    def volume_unmount(req):
        vs.volume_unmount(req.volume_id)
        return vpb.VolumeUnmountResponse()

    @unary("VolumeStatus", vpb.VolumeStatusRequest, vpb.VolumeStatusResponse)
    def volume_status(req):
        return vpb.VolumeStatusResponse(**vs.volume_status(req.volume_id))

    @unary("Ping", vpb.PingRequest, vpb.PingResponse)
    def ping(req):
        return vpb.PingResponse(**vs.ping())

    @unary("ReadVolumeFileStatus", vpb.ReadVolumeFileStatusRequest,
           vpb.ReadVolumeFileStatusResponse)
    def file_status(req):
        return vpb.ReadVolumeFileStatusResponse(
            **vs.read_volume_file_status(req.volume_id))

    @stream("CopyFile", vpb.CopyFileRequest, vpb.CopyFileResponse)
    def copy_file(req):
        for chunk in vs.copy_file(req.volume_id, req.collection, req.ext,
                                  req.is_ec_volume):
            yield vpb.CopyFileResponse(file_content=chunk)

    @unary("VolumeScrub", vpb.VolumeScrubRequest, vpb.VolumeScrubResponse)
    def volume_scrub(req):
        resp = vpb.VolumeScrubResponse()
        for r in vs.volume_scrub(req.volume_id, req.device,
                                 req.time_budget_s):
            resp.results.add(**r)
        return resp

    # -- the maintenance plane -------------------------------------------------
    @unary("VolumeCopy", vpb.VolumeCopyRequest, vpb.VolumeCopyResponse)
    def volume_copy(req):
        return vpb.VolumeCopyResponse(last_append_at_ns=vs.volume_copy(
            req.volume_id, req.collection, req.source_data_node,
            req.disk_type))

    @unary("VolumeSyncStatus", vpb.VolumeSyncStatusRequest,
           vpb.VolumeSyncStatusResponse)
    def volume_sync_status(req):
        return vpb.VolumeSyncStatusResponse(
            **vs.volume_sync_status(req.volume_id))

    @stream("VolumeIncrementalCopy", vpb.VolumeIncrementalCopyRequest,
            vpb.VolumeIncrementalCopyResponse)
    def volume_incremental_copy(req):
        for chunk in vs.volume_incremental_copy(req.volume_id, req.since_ns):
            yield vpb.VolumeIncrementalCopyResponse(file_content=chunk)

    def tail_sender(req, context):
        for rec, ts in vs.volume_tail_sender(
                req.volume_id, req.since_ns, req.idle_timeout_seconds,
                alive=context.is_active):
            yield vpb.VolumeTailSenderResponse(needle_record=rec,
                                               append_at_ns=ts)
    svc.unary_stream("VolumeTailSender", vpb.VolumeTailSenderRequest,
                     vpb.VolumeTailSenderResponse)(
        _aborting_subscription(tail_sender))

    @unary("VolumeTailReceiver", vpb.VolumeTailReceiverRequest,
           vpb.VolumeTailReceiverResponse)
    def tail_receiver(req):
        return vpb.VolumeTailReceiverResponse(
            received=vs.volume_tail_receiver(
                req.volume_id, req.since_ns, req.idle_timeout_seconds,
                req.source_volume_server))

    @unary("BatchDelete", vpb.BatchDeleteRequest, vpb.BatchDeleteResponse)
    def batch_delete(req):
        resp = vpb.BatchDeleteResponse()
        for r in vs.batch_delete(list(req.file_ids)):
            resp.results.add(**r)
        return resp

    @unary("VolumeConfigure", vpb.VolumeConfigureRequest,
           vpb.VolumeConfigureResponse)
    def volume_configure(req):
        return vpb.VolumeConfigureResponse(
            error=vs.volume_configure(req.volume_id, req.replication))

    @unary("VolumeServerLeave", vpb.VolumeServerLeaveRequest,
           vpb.VolumeServerLeaveResponse)
    def volume_server_leave(req):
        vs.volume_server_leave()
        return vpb.VolumeServerLeaveResponse()

    @unary("VolumeNeedleStatus", vpb.VolumeNeedleStatusRequest,
           vpb.VolumeNeedleStatusResponse)
    def volume_needle_status(req):
        return vpb.VolumeNeedleStatusResponse(
            **vs.volume_needle_status(req.volume_id, req.needle_id))

    @stream("Query", vpb.QueryRequest, vpb.QueriedStripe)
    def query(req):
        for records in vs.query(
                list(req.from_file_ids), req.filter.field,
                req.filter.operand, req.filter.value, list(req.projections),
                req.input_serialization.format,
                req.input_serialization.csv_delimiter,
                req.input_serialization.csv_has_header,
                req.output_serialization.format,
                req.output_serialization.csv_delimiter):
            yield vpb.QueriedStripe(records=records)

    # -- vacuum ----------------------------------------------------------------
    @unary("VacuumVolumeCheck", vpb.VacuumVolumeCheckRequest,
           vpb.VacuumVolumeCheckResponse)
    def vacuum_check(req):
        return vpb.VacuumVolumeCheckResponse(
            garbage_ratio=vs.vacuum_volume_check(req.volume_id))

    @unary("VacuumVolumeCompact", vpb.VacuumVolumeCompactRequest,
           vpb.VacuumVolumeCompactResponse)
    def vacuum_compact(req):
        return vpb.VacuumVolumeCompactResponse(
            processed_bytes=vs.vacuum_volume_compact(req.volume_id))

    @unary("VacuumVolumeCommit", vpb.VacuumVolumeCommitRequest,
           vpb.VacuumVolumeCommitResponse)
    def vacuum_commit(req):
        return vpb.VacuumVolumeCommitResponse(
            volume_size=vs.vacuum_volume_commit(req.volume_id))

    @unary("VacuumVolumeCleanup", vpb.VacuumVolumeCleanupRequest,
           vpb.VacuumVolumeCleanupResponse)
    def vacuum_cleanup(req):
        vs.vacuum_volume_cleanup(req.volume_id)
        return vpb.VacuumVolumeCleanupResponse()

    # -- the EC set ------------------------------------------------------------
    @unary("VolumeEcShardsGenerate", vpb.VolumeEcShardsGenerateRequest,
           vpb.VolumeEcShardsGenerateResponse)
    def ec_generate(req):
        vs.volume_ec_shards_generate(req.volume_id, req.collection,
                                     req.data_shards, req.parity_shards,
                                     req.codec)
        return vpb.VolumeEcShardsGenerateResponse()

    @unary("VolumeEcShardsGenerateBatch",
           vpb.VolumeEcShardsGenerateBatchRequest,
           vpb.VolumeEcShardsGenerateBatchResponse)
    def ec_generate_batch(req):
        return vpb.VolumeEcShardsGenerateBatchResponse(
            **vs.volume_ec_shards_generate_batch(
                list(req.volume_ids), req.collection, req.data_shards,
                req.parity_shards, req.codec))

    @unary("VolumeEcShardsInfo", vpb.VolumeEcShardsInfoRequest,
           vpb.VolumeEcShardsInfoResponse)
    def ec_info(req):
        return vpb.VolumeEcShardsInfoResponse(
            **vs.volume_ec_shards_info(req.volume_id, req.collection))

    def _rebuilt(r, resp_cls):
        return resp_cls(rebuilt_shard_ids=r["rebuilt_shard_ids"],
                        bytes_read=r["bytes_read"],
                        bytes_written=r["bytes_written"])

    @unary("VolumeEcShardsRebuild", vpb.VolumeEcShardsRebuildRequest,
           vpb.VolumeEcShardsRebuildResponse)
    def ec_rebuild(req):
        return _rebuilt(vs.volume_ec_shards_rebuild(req.volume_id,
                                                    req.collection),
                        vpb.VolumeEcShardsRebuildResponse)

    @unary("VolumeEcShardsCopy", vpb.VolumeEcShardsCopyRequest,
           vpb.VolumeEcShardsCopyResponse)
    def ec_copy(req):
        vs.volume_ec_shards_copy(
            req.volume_id, req.collection, list(req.shard_ids),
            copy_ecx_file=req.copy_ecx_file, copy_ecj_file=req.copy_ecj_file,
            copy_vif_file=req.copy_vif_file,
            source_data_node=req.source_data_node)
        return vpb.VolumeEcShardsCopyResponse()

    @unary("VolumeEcShardsCopyByRebuild",
           vpb.VolumeEcShardsCopyByRebuildRequest,
           vpb.VolumeEcShardsCopyByRebuildResponse)
    def ec_copy_by_rebuild(req):
        return _rebuilt(vs.volume_ec_shards_copy_by_rebuild(
            req.volume_id, req.collection, list(req.shard_ids)),
            vpb.VolumeEcShardsCopyByRebuildResponse)

    @unary("VolumeEcShardsMount", vpb.VolumeEcShardsMountRequest,
           vpb.VolumeEcShardsMountResponse)
    def ec_mount(req):
        # every shard file on disk mounts, as in the JAX package
        vs.volume_ec_shards_mount(req.volume_id, req.collection)
        return vpb.VolumeEcShardsMountResponse()

    @unary("VolumeEcShardsUnmount", vpb.VolumeEcShardsUnmountRequest,
           vpb.VolumeEcShardsUnmountResponse)
    def ec_unmount(req):
        vs.volume_ec_shards_unmount(req.volume_id, list(req.shard_ids))
        return vpb.VolumeEcShardsUnmountResponse()

    @unary("VolumeEcShardsDelete", vpb.VolumeEcShardsDeleteRequest,
           vpb.VolumeEcShardsDeleteResponse)
    def ec_delete(req):
        vs.volume_ec_shards_delete(req.volume_id, req.collection,
                                   list(req.shard_ids))
        return vpb.VolumeEcShardsDeleteResponse()

    @unary("VolumeEcShardsMove", vpb.VolumeEcShardsMoveRequest,
           vpb.VolumeEcShardsMoveResponse)
    def ec_move(req):
        vs.volume_ec_shards_move(req.volume_id, req.collection,
                                 list(req.shard_ids), req.source_data_node)
        return vpb.VolumeEcShardsMoveResponse()

    @stream("VolumeEcShardRead", vpb.VolumeEcShardReadRequest,
            vpb.VolumeEcShardReadResponse)
    def ec_shard_read(req):
        for data in vs.volume_ec_shard_read(
                req.volume_id, req.shard_id, offset=req.offset,
                size=req.size, fragment_offsets=list(req.fragment_offsets),
                fragment_lengths=list(req.fragment_lengths),
                combine_rows=req.combine_rows,
                combine_matrix=req.combine_matrix,
                gather_shard_ids=list(req.gather_shard_ids),
                gather_sources=list(req.gather_sources)):
            yield vpb.VolumeEcShardReadResponse(data=data)

    @unary("VolumeEcBlobDelete", vpb.VolumeEcBlobDeleteRequest,
           vpb.VolumeEcBlobDeleteResponse)
    def ec_blob_delete(req):
        vs.volume_ec_blob_delete(req.volume_id, req.file_key, req.collection)
        return vpb.VolumeEcBlobDeleteResponse()

    @unary("VolumeEcShardsToVolume", vpb.VolumeEcShardsToVolumeRequest,
           vpb.VolumeEcShardsToVolumeResponse)
    def ec_to_volume(req):
        vs.volume_ec_shards_to_volume(req.volume_id, req.collection)
        return vpb.VolumeEcShardsToVolumeResponse()

    # message reuse, as the JAX package's: since_ns = the DestroyTime
    # instant in nanoseconds (see volume_server.proto)
    @unary("VolumeEcShardsSetDestroyTime", vpb.VolumeTailReceiverRequest,
           vpb.VolumeTailReceiverResponse)
    def ec_set_destroy_time(req):
        vs.volume_ec_shards_set_destroy_time(req.volume_id,
                                             req.since_ns / 1e9)
        return vpb.VolumeTailReceiverResponse(received=1)

    # -- tier moves ------------------------------------------------------------
    @unary("VolumeTierMoveDatToRemote", vpb.VolumeTierMoveDatToRemoteRequest,
           vpb.VolumeTierMoveDatToRemoteResponse)
    def tier_upload(req):
        return vpb.VolumeTierMoveDatToRemoteResponse(
            **vs.volume_tier_move_dat_to_remote(
                req.volume_id, req.destination_backend_name,
                req.keep_local_dat_file))

    @unary("VolumeTierMoveDatFromRemote",
           vpb.VolumeTierMoveDatFromRemoteRequest,
           vpb.VolumeTierMoveDatFromRemoteResponse)
    def tier_download(req):
        return vpb.VolumeTierMoveDatFromRemoteResponse(
            **vs.volume_tier_move_dat_from_remote(
                req.volume_id, req.keep_remote_dat_file))

    # the .dat tier messages reused at shard granularity, as the JAX
    # package's (see volume_server.proto)
    @unary("VolumeEcShardsTierMoveToRemote",
           vpb.VolumeTierMoveDatToRemoteRequest,
           vpb.VolumeTierMoveDatToRemoteResponse)
    def ec_tier_offload(req):
        return vpb.VolumeTierMoveDatToRemoteResponse(
            **vs.volume_ec_shards_tier_move_to_remote(
                req.volume_id, req.collection, req.destination_backend_name))

    @unary("VolumeEcShardsTierMoveFromRemote",
           vpb.VolumeTierMoveDatFromRemoteRequest,
           vpb.VolumeTierMoveDatFromRemoteResponse)
    def ec_tier_promote(req):
        return vpb.VolumeTierMoveDatFromRemoteResponse(
            **vs.volume_ec_shards_tier_move_from_remote(
                req.volume_id, req.collection, req.keep_remote_dat_file))

    return svc


class GrpcPeers:
    """The network peer plane: other volume servers over gRPC, and the
    master's LookupVolume and LookupEcVolume (the latter also teaches each
    holder's data center).
    `master` is a comma-separated list; lookups go to the heartbeat's
    current leader when one is bound."""

    def __init__(self, master: str):
        self.masters = [m for m in master.split(",") if m]
        self.leader = self.masters[0]
        self._dc: dict[str, str] = {}

    def data_center(self, addr: str) -> str:
        return self._dc.get(addr, "")

    def lookup_volume(self, vid: int) -> "list[str]":
        """HTTP urls of the volume's holders (the master's LookupVolume)."""
        resp = Stub(self.leader, MASTER_SERVICE).call(
            "LookupVolume",
            mpb.LookupVolumeRequest(volume_or_file_ids=[str(vid)]),
            mpb.LookupVolumeResponse, timeout=5)
        for e in resp.volume_id_locations:
            return [loc.url for loc in e.locations]
        return []

    def lookup_ec(self, vid: int) -> "dict[int, list[str]]":
        resp = Stub(self.leader, MASTER_SERVICE).call(
            "LookupEcVolume", mpb.LookupEcVolumeRequest(volume_id=vid),
            mpb.LookupEcVolumeResponse, timeout=5)
        locs: dict[int, list[str]] = {}
        for e in resp.shard_id_locations:
            addrs = []
            for loc in e.locations:
                addr = f"{loc.url.rsplit(':', 1)[0]}:{loc.grpc_port}"
                addrs.append(addr)
                if loc.data_center:
                    self._dc[addr] = loc.data_center
            locs[e.shard_id] = addrs
        return locs

    def read_shard(self, addr: str, vid: int, sid: int, offset: int,
                   size: int) -> bytes:
        return b"".join(r.data for r in Stub(addr, VOLUME_SERVICE).call_stream(
            "VolumeEcShardRead",
            vpb.VolumeEcShardReadRequest(volume_id=vid, shard_id=sid,
                                         offset=offset, size=size),
            vpb.VolumeEcShardReadResponse))

    def read_fragment(self, addr: str, vid: int, sid: int, ranges,
                      combine_rows: int = 0, combine_matrix: bytes = b"",
                      gather_shard_ids=(), gather_sources=()) -> bytes:
        return b"".join(r.data for r in Stub(addr, VOLUME_SERVICE).call_stream(
            "VolumeEcShardRead",
            vpb.VolumeEcShardReadRequest(
                volume_id=vid, shard_id=sid,
                fragment_offsets=[o for o, _ in ranges],
                fragment_lengths=[ln for _, ln in ranges],
                combine_rows=combine_rows, combine_matrix=combine_matrix,
                gather_shard_ids=list(gather_shard_ids),
                gather_sources=list(gather_sources)),
            vpb.VolumeEcShardReadResponse))

    def copy_file(self, addr: str, vid: int, collection: str, ext: str,
                  is_ec_volume: bool = False):
        for r in Stub(addr, VOLUME_SERVICE).call_stream(
                "CopyFile",
                vpb.CopyFileRequest(volume_id=vid, collection=collection,
                                    ext=ext, is_ec_volume=is_ec_volume),
                vpb.CopyFileResponse):
            yield r.file_content

    def tail_sender(self, addr: str, vid: int, since_ns: int,
                    idle_timeout_seconds: int):
        for r in Stub(addr, VOLUME_SERVICE).call_stream(
                "VolumeTailSender",
                vpb.VolumeTailSenderRequest(
                    volume_id=vid, since_ns=since_ns,
                    idle_timeout_seconds=idle_timeout_seconds),
                vpb.VolumeTailSenderResponse):
            yield r.needle_record, r.append_at_ns

    def ec_shards_info(self, addr: str, vid: int, collection: str) -> dict:
        r = Stub(addr, VOLUME_SERVICE).call(
            "VolumeEcShardsInfo",
            vpb.VolumeEcShardsInfoRequest(volume_id=vid,
                                          collection=collection),
            vpb.VolumeEcShardsInfoResponse)
        return {"data_shards": r.data_shards, "parity_shards": r.parity_shards,
                "dat_size": r.dat_size, "codec": r.codec,
                "shard_size": r.shard_size,
                "local_shard_ids": list(r.local_shard_ids),
                "remote_shard_ids": list(r.remote_shard_ids)}

    def ec_shards_delete(self, addr: str, vid: int, collection: str,
                         shard_ids) -> None:
        Stub(addr, VOLUME_SERVICE).call(
            "VolumeEcShardsDelete",
            vpb.VolumeEcShardsDeleteRequest(volume_id=vid,
                                            collection=collection,
                                            shard_ids=list(shard_ids)),
            vpb.VolumeEcShardsDeleteResponse)


class Heartbeater:
    """The SendHeartbeat stream to the master, fed from vs.heartbeat()
    every pulse and on `trigger()`. `flush()` blocks until the master has
    answered a heartbeat covering every change made before the call (the
    master answers 1:1 after ingesting each one). Leader hints move the
    stream; failures rotate through the master list. After
    VolumeServerLeave (`vs.left`) the stream ends within a pulse and is
    not reopened, so the master forgets the server."""

    def __init__(self, vs: VolumeServer, peers: GrpcPeers):
        self.vs = vs
        self.peers = peers
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._cond = threading.Condition()
        self._state_seq = 0
        self._acked_seq = -1
        self._inflight: "list[int]" = []
        self._stream = None
        self._rr = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"vs-hb-{vs.port}")

    def start(self) -> None:
        self._thread.start()

    def _gone(self) -> bool:
        return self._stop.is_set() or self.vs.left.is_set()

    def _messages(self):
        while not self._gone():
            # the seq is read before the snapshot: acking it proves the
            # master saw every mutation that bumped it before this point
            snap_seq = self._state_seq
            hb = self.vs.heartbeat()
            msg = mpb.Heartbeat(
                ip=hb["ip"], port=hb["port"], grpc_port=hb["grpc_port"],
                public_url=hb["public_url"], max_file_key=hb["max_file_key"],
                data_center=hb["data_center"], rack=hb["rack"],
                max_volume_counts=hb["max_volume_counts"],
                has_no_volumes=hb["has_no_volumes"],
                has_no_ec_shards=hb["has_no_ec_shards"])
            for v in hb["volumes"]:
                msg.volumes.add(**v)
            for s in hb["ec_shards"]:
                msg.ec_shards.add(**s)
            with self._cond:
                self._inflight.append(snap_seq)
            yield msg
            self._wake.wait(timeout=self.vs.pulse_seconds)
            self._wake.clear()

    def _loop(self) -> None:
        while not self._gone():
            try:
                stream = Stub(self.peers.leader, MASTER_SERVICE).stream_stream(
                    "SendHeartbeat", self._messages(), mpb.Heartbeat,
                    mpb.HeartbeatResponse)
                self._stream = stream  # stop() cancels it to unblock us
                if self._stop.is_set():
                    stream.cancel()
                    return
                for resp in stream:
                    with self._cond:
                        if self._inflight:
                            self._acked_seq = self._inflight.pop(0)
                            self._cond.notify_all()
                    if resp.leader and resp.leader != self.peers.leader:
                        log.info("leader moved to %s", resp.leader)
                        self.peers.leader = resp.leader
                        break
                    if self._stop.is_set():
                        return
            except Exception as e:  # noqa: BLE001 — reconnect after a pause
                if not self._stop.is_set():
                    log.warning("heartbeat to %s failed: %s; retrying",
                                self.peers.leader, e)
                    masters = self.peers.masters
                    if len(masters) > 1:
                        self._rr = (self._rr + 1) % len(masters)
                        self.peers.leader = masters[self._rr]
                    self._stop.wait(min(self.vs.pulse_seconds, 2.0))
            finally:
                with self._cond:
                    # unacked sends died with the stream; the next stream
                    # re-sends the full state
                    self._inflight.clear()
                    self._cond.notify_all()

    def trigger(self) -> None:
        with self._cond:
            self._state_seq += 1
        self._wake.set()

    def flush(self, timeout: float = 3.0) -> bool:
        if self._gone():
            return False
        with self._cond:
            self._state_seq += 1
            target = self._state_seq
        self._wake.set()
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._acked_seq < target:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._gone():
                    return False
                self._cond.wait(min(remaining, 0.25))
        return True

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        stream = self._stream
        if stream is not None:
            stream.cancel()
        self._thread.join(timeout=5.0)


class VolumeGrpc:
    """A served volume server: its gRPC server and, with a master, its
    heartbeat stream. `stop()` ends both, then the core."""

    def __init__(self, vs: VolumeServer, server: grpc.Server,
                 heartbeater: "Heartbeater | None"):
        self.vs = vs
        self.server = server
        self.heartbeater = heartbeater

    def stop(self) -> None:
        if self.heartbeater is not None:
            self.vs.heartbeat_flush = None
            self.heartbeater.stop()
        self.server.stop(grace=0.5).wait(timeout=5.0)
        self.vs.stop()


def serve_volume(vs: VolumeServer, grpc_port: "int | None" = None,
                 master: str = "") -> VolumeGrpc:
    """Serve core `vs` over gRPC on `grpc_port` (by default its own) and,
    when `master` is given, heartbeat to it and reach peers through it
    (GrpcPeers); a core that already has peers keeps them. Starts the HTTP
    plane too if it is not running. A core whose guard has a signing key
    sets the process's gRPC cluster key from it and serves only callers
    that carry the cluster token, as the JAX package's server does."""
    if grpc_port:
        vs.grpc_port = grpc_port
    vs.peer_address = f"{vs.ip}:{vs.grpc_port}"
    key = vs.guard.signing_key if vs.guard is not None else ""
    if key:
        set_cluster_key(key)
    server = serve(f"{vs.ip}:{vs.grpc_port}", [build_service(vs)],
                   auth_key=key)
    heartbeater = None
    try:
        if master:
            vs.masters = [m for m in master.split(",") if m]
            peers = GrpcPeers(master)
            if vs.peers is None:
                vs.peers = peers
            heartbeater = Heartbeater(vs, peers)
            vs.heartbeat_flush = heartbeater.flush
            heartbeater.start()
        if vs._http_thread is None:
            vs.start()
    except Exception:
        if heartbeater is not None:
            heartbeater.stop()
        server.stop(grace=0)
        raise
    log.info("volume server %s serving gRPC on :%d", vs.url, vs.grpc_port)
    return VolumeGrpc(vs, server, heartbeater)
