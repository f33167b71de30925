"""Local control socket for a live kernel mount.

Reference: `weed shell mount.configure` dials the mount process over a
unix socket derived from the mount directory
(command_mount_configure.go: /tmp/seaweedfs-mount-<hash>.sock) and calls
the mount_pb Configure RPC (CollectionCapacity quota). Same wire shape
here: one length-prefixed mount_pb.ConfigureRequest per connection,
answered by a length-prefixed ConfigureResponse (pb/mount.proto).

The port's copy of seaweedfs_tpu/mount/control.py, unchanged: the same
socket path for a directory and the same frames, so the reference's
`configure_mount` reaches a port mount and the port's a reference one.
That is why the socket sits at a literal /tmp path and not under
$TMPDIR: a mount and a shell that saw different $TMPDIRs would not meet.
The path hashes the mount directory's absolute path, so two mounts meet
only at one directory; keep each mount directory apart (the smoke's
under its work directory, each test's under its tmp_path).
"""

from __future__ import annotations

import hashlib
import os
import socket
import struct
import threading

from ..pb import mount_pb2 as mpb


def mount_socket_path(mount_dir: str) -> str:
    """Stable per-mountpoint socket path (reference HashToInt32 of the
    dir; any stable digest works as long as shell and mount agree)."""
    h = hashlib.md5(os.path.abspath(mount_dir).encode(),
                    usedforsecurity=False).hexdigest()[:12]
    return f"/tmp/swtpu-mount-{h}.sock"


def _send_msg(conn: socket.socket, msg) -> None:
    raw = msg.SerializeToString()
    conn.sendall(struct.pack(">I", len(raw)) + raw)


def _recv_msg(rf, cls):
    hdr = rf.read(4)
    if len(hdr) < 4:
        raise ConnectionError("control peer closed")
    (n,) = struct.unpack(">I", hdr)
    raw = rf.read(n)
    if len(raw) < n:
        raise ConnectionError("truncated control message")
    msg = cls()
    msg.ParseFromString(raw)
    return msg


def serve_mount_control(wfs, sock_path: str):
    """Answer ConfigureRequest messages against the live WeedFS.
    Returns a stop() closure."""
    try:
        os.unlink(sock_path)
    except FileNotFoundError:
        pass
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(sock_path)
    srv.listen(2)
    stop_flag = threading.Event()

    def loop():
        while not stop_flag.is_set():
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            with conn:
                resp = mpb.ConfigureResponse()
                try:
                    conn.settimeout(5.0)  # a silent client must not wedge
                    req = _recv_msg(conn.makefile("rb"),
                                    mpb.ConfigureRequest)
                    # apply unconditionally: capacity 0 CLEARS a quota
                    wfs.configure(req.collection_capacity)
                    resp.collection_capacity = wfs.collection_capacity
                except Exception as e:  # noqa: BLE001
                    resp.error = str(e)
                try:
                    _send_msg(conn, resp)
                except OSError:
                    pass

    t = threading.Thread(target=loop, daemon=True, name="mount-control")
    t.start()

    def stop():
        stop_flag.set()
        try:
            srv.close()
        except OSError:
            pass
        try:
            os.unlink(sock_path)
        except FileNotFoundError:
            pass

    return stop


def configure_mount(mount_dir: str, collection_capacity: int) -> dict:
    """Client side (the shell command): one request/response."""
    path = mount_socket_path(mount_dir)
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.settimeout(5.0)
    try:
        c.connect(path)
        _send_msg(c, mpb.ConfigureRequest(
            collection_capacity=collection_capacity))
        resp = _recv_msg(c.makefile("rb"), mpb.ConfigureResponse)
        out = {"ok": not resp.error,
               "collection_capacity": resp.collection_capacity}
        if resp.error:
            out["error"] = resp.error
        return out
    finally:
        c.close()
