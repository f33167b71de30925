"""Mount an external object store path into the filer namespace.

Reference behavior (weed/filer/read_remote.go, remote_mapping.go, shell
remote.mount/remote.cache/remote.uncache):
- remote.mount imports the remote listing as entries whose `extended`
  metadata carries the remote ref; no data is copied.
- reads of an uncached entry stream straight from the remote store.
- remote.cache materializes chunks in the blob cluster (after which
  reads are local); remote.uncache drops them again.
- mappings persist at /etc/remote/mount.json (reference stores them in
  the filer the same way).

Remote refs live in entry.extended["remote"] as JSON
{"spec": backend spec, "key": object key, "size": bytes}.

The port's copy of seaweedfs_tpu/remote/remote_mount.py: the same
functions, the same mapping file and the same entry bytes, so a tree
mounted by either package is cached, synced and unmounted by the other.
It differs in two places, each a fault of the reference:
* The reference's `_load_mappings` returns {} on any failure, so a failed
  read of /etc/remote/mount.json (a lost volume, a filer that times out)
  makes the next `mount_remote` or `unmount_remote` save {} plus one
  mapping and wipe every other mount's. Here {} means only that the file
  does not exist; a failed read or parse raises.
* The reference's `mount_remote`, which remote.meta.sync calls, creates
  every listed entry again: each cached entry loses its chunks (and the
  replaced chunks are deleted), and an entry whose object left the remote
  stays, so its next uncached read fails. Here an entry is kept as it is,
  cached chunks included, only when the object is provably unchanged:
  its remote ref (spec, key, size) is the same and so is the object's
  version (`object_version`: an ETag, a generation, a file's mtime and
  inode), recorded under extended["remote.version"] when the entry was
  made and when its bytes were cached. Any other listed entry is made
  anew, as the reference makes it, so an object overwritten in place at
  the same size reads its new bytes; a store that gives no version keeps
  nothing. The entries of the mount's objects that the listing no longer
  holds are removed. extended["remote"] and the mapping file stay
  byte-equal to the reference's; the version is a key of its own (not
  the entry's mtime, which is whole seconds and which the filer sets
  whenever the entry is written).
"""

from __future__ import annotations

import json

from ..filer.filer import join_path, split_path
from ..pb import filer_pb2 as fpb
from ..storage.backend import open_remote
from ..utils.log import logger

log = logger("remote")

MOUNT_CONF = "/etc/remote/mount.json"
REMOTE_KEY = b"remote"  # extended map key (bytes per proto)
# the object's version when the entry's bytes were taken from the remote
VERSION_KEY = "remote.version"


def _load_mappings(fs) -> dict:
    """Mappings persist as remote_pb.RemoteStorageMapping proto-JSON
    (reference stores remote.proto messages under /etc/remote the same
    way); legacy plain-JSON files from earlier rounds still load.

    {} only when the file does not exist. A read or parse that fails
    raises: a caller that saved {} plus its own mapping would wipe every
    other mount's."""
    from google.protobuf import json_format

    from ..pb import remote_pb2 as rpb
    d, n = split_path(MOUNT_CONF)
    entry = fs.filer.find_entry(d, n)
    if entry is None:
        return {}
    doc = json.loads(fs.read_entry_bytes(entry))
    if not isinstance(doc, dict):
        raise ValueError(f"{MOUNT_CONF} holds no mapping table")
    if "mappings" in doc:
        # tolerate unknown fields: a hand edit or newer schema still loads
        msg = json_format.ParseDict(doc, rpb.RemoteStorageMapping(),
                                    ignore_unknown_fields=True)
        return {dir_: {"spec": m.spec, "prefix": m.prefix}
                for dir_, m in msg.mappings.items()}
    return doc  # legacy flat dict


def _save_mappings(fs, mappings: dict) -> None:
    from google.protobuf import json_format

    from ..pb import remote_pb2 as rpb
    msg = rpb.RemoteStorageMapping()
    for dir_, m in mappings.items():
        msg.mappings[dir_].spec = m.get("spec", "")
        msg.mappings[dir_].prefix = m.get("prefix", "")
    fs.write_file(MOUNT_CONF,
                  json_format.MessageToJson(msg, indent=2).encode(),
                  mime="application/json")


def mount_remote(fs, directory: str, spec: str, prefix: str = "") -> int:
    """Import the remote listing under `directory`; returns entry count.

    Mounting again (remote.meta.sync) keeps an entry whose object is
    unchanged (the same ref and version), with its cached chunks, makes
    the others anew and removes the entries whose objects left the
    listing; local files under the mount stay."""
    client = open_remote(spec)
    count = 0
    listed: set = set()
    for key in client.list_keys(prefix):
        rel = key[len(prefix):].lstrip("/") if prefix else key
        if not rel:
            continue
        path = join_path(directory, rel)
        d, n = split_path(path)
        size = client.object_size(key)
        version = client.object_version(key).encode()
        ref = json.dumps({"spec": spec, "key": key, "size": size}).encode()
        listed.add(path)
        count += 1
        old = fs.filer.find_entry(d, n)
        if old is not None and version and \
                bytes(old.extended.get(REMOTE_KEY.decode(), b"")) == ref and \
                bytes(old.extended.get(VERSION_KEY, b"")) == version:
            continue
        entry = fpb.Entry(name=n)
        entry.attributes.file_size = size
        entry.attributes.file_mode = 0o644
        entry.extended[REMOTE_KEY.decode()] = ref
        if version:
            entry.extended[VERSION_KEY] = version
        fs.filer.create_entry(d, entry)
    _prune(fs, directory, spec, prefix, listed)
    mappings = _load_mappings(fs)
    mappings[directory] = {"spec": spec, "prefix": prefix}
    _save_mappings(fs, mappings)
    log.info("mounted %s (%s, prefix=%r): %d entries",
             directory, spec, prefix, count)
    return count


def _prune(fs, directory: str, spec: str, prefix: str,
           listed: set) -> None:
    """Remove the entries under `directory` of objects of `spec` under
    `prefix` that the listing no longer holds (a mount of another remote
    nested below keeps its own)."""
    d, n = split_path(directory)
    if directory != "/" and fs.filer.find_entry(d, n) is None:
        return
    for e in list(fs.filer.list_entries(directory)):
        path = join_path(directory, e.name)
        ref = remote_ref(e)
        if e.is_directory:
            _prune(fs, path, spec, prefix, listed)
        elif ref is not None and path not in listed and \
                ref.get("spec") == spec and \
                str(ref.get("key", "")).startswith(prefix):
            fs.filer.delete_entry(directory, e.name, is_delete_data=True)


def unmount_remote(fs, directory: str) -> None:
    d, n = split_path(directory)
    if fs.filer.find_entry(d, n) is not None:
        fs.filer.delete_entry(d, n, is_recursive=True, is_delete_data=True)
    mappings = _load_mappings(fs)
    mappings.pop(directory, None)
    _save_mappings(fs, mappings)


def remote_ref(entry: fpb.Entry) -> dict | None:
    raw = entry.extended.get(REMOTE_KEY.decode())
    if not raw:
        return None
    try:
        return json.loads(raw)
    except Exception:  # noqa: BLE001
        return None


def read_remote(entry: fpb.Entry, offset: int = 0,
                size: int | None = None) -> bytes:
    """Stream an uncached remote entry's bytes (read_remote.go)."""
    ref = remote_ref(entry)
    if ref is None:
        raise ValueError("entry has no remote ref")
    client = open_remote(ref["spec"])
    total = ref.get("size") or client.object_size(ref["key"])
    if size is None:
        size = total - offset
    size = max(0, min(size, total - offset))
    if size == 0:
        return b""
    return client.read_object(ref["key"], offset, size)


def cache_remote(fs, path: str) -> fpb.Entry:
    """Materialize a remote entry's data as local chunks
    (shell remote.cache)."""
    d, n = split_path(path)
    entry = fs.filer.find_entry(d, n)
    if entry is None:
        raise FileNotFoundError(path)
    ref = remote_ref(entry)
    if ref is None:
        raise ValueError(f"{path} is not a remote entry")
    if entry.chunks:
        return entry  # already cached
    # the version before the bytes: a write in between leaves a version
    # older than the bytes, which the next meta.sync makes anew
    version = open_remote(ref["spec"]).object_version(ref["key"]).encode()
    data = read_remote(entry)
    cached = fs.write_file(path, data, mime=entry.attributes.mime)
    # keep the remote ref so uncache can revert
    updated = fs.filer.find_entry(d, n)
    updated.extended[REMOTE_KEY.decode()] = json.dumps(ref).encode()
    if version:
        updated.extended[VERSION_KEY] = version
    else:
        updated.extended.pop(VERSION_KEY, None)
    fs.filer.update_entry(d, updated)
    return cached


def uncache_remote(fs, path: str) -> None:
    """Drop local chunks, keep the remote ref (shell remote.uncache)."""
    d, n = split_path(path)
    entry = fs.filer.find_entry(d, n)
    if entry is None:
        raise FileNotFoundError(path)
    ref = remote_ref(entry)
    if ref is None:
        raise ValueError(f"{path} is not a remote entry")
    if not entry.chunks:
        return
    # update_entry's replaced-chunk GC deletes the dropped chunks server-side
    updated = fpb.Entry()
    updated.CopyFrom(entry)
    del updated.chunks[:]
    updated.attributes.file_size = ref.get("size", 0)
    fs.filer.update_entry(d, updated)


# -- write-back sync (weed filer.remote.sync / filer.remote.gateway) ------

def find_mapping(mappings: dict, path: str) -> "tuple[str, dict] | None":
    """Longest mounted-directory prefix covering `path`."""
    best = None
    for directory, m in mappings.items():
        if path == directory or path.startswith(directory.rstrip("/") + "/"):
            if best is None or len(directory) > len(best[0]):
                best = (directory, m)
    return best


def remote_key_for(mount_dir: str, m: dict, path: str) -> str:
    rel = path[len(mount_dir):].lstrip("/")
    prefix = (m.get("prefix") or "").strip("/")
    return f"{prefix}/{rel}" if prefix else rel


def apply_event_to_remote(fs, mappings: dict, directory: str,
                          ev: fpb.EventNotification) -> "str | None":
    """Write one filer metadata event back to the remote store backing
    its mount (reference command/filer_remote_sync.go). Returns a short
    action string, or None when the event doesn't touch a mount.

    Events whose entry carries ONLY a remote ref (no local chunks) came
    FROM the remote import itself and are skipped — without this guard
    the sync would re-upload every object right after remote.mount."""
    has_old = ev.HasField("old_entry") and bool(ev.old_entry.name)
    has_new = ev.HasField("new_entry") and bool(ev.new_entry.name)
    old_path = join_path(directory, ev.old_entry.name) if has_old else ""
    new_dir = ev.new_parent_path or directory
    new_path = join_path(new_dir, ev.new_entry.name) if has_new else ""

    is_rename = has_old and has_new and new_path != old_path
    actions = []
    if has_new and not ev.new_entry.is_directory:
        hit = find_mapping(mappings, new_path)
        if hit:
            client = open_remote(hit[1]["spec"])
            key = remote_key_for(hit[0], hit[1], new_path)
            if ev.new_entry.chunks:
                # metadata-only updates (chmod/utime) keep the chunk list
                # identical — don't re-upload a large unchanged object
                same_content = (not is_rename and has_old and
                                [c.file_id for c in ev.old_entry.chunks] ==
                                [c.file_id for c in ev.new_entry.chunks])
                if not same_content:
                    client.write_object_bytes(
                        key, fs.read_entry_bytes(ev.new_entry))
                    actions.append(f"upload {key}")
            elif is_rename and remote_ref(ev.new_entry) is not None:
                # rename of a remote-only file: copy remote-side BEFORE
                # the delete below, or the object is lost
                old_hit = find_mapping(mappings, old_path)
                if old_hit:
                    src = open_remote(old_hit[1]["spec"])
                    old_key = remote_key_for(old_hit[0], old_hit[1],
                                             old_path)
                    size = src.object_size(old_key)
                    client.write_object_bytes(
                        key, src.read_object(old_key, 0, size))
                    actions.append(f"copy {old_key} -> {key}")
            elif remote_ref(ev.new_entry) is None and \
                    (not has_old or is_rename or ev.old_entry.chunks
                     or remote_ref(ev.old_entry) is not None):
                # empty local file: fresh create, rename, or
                # truncate-to-empty of content that existed locally
                # (chunks) OR remote-only (ref) — but NOT a metadata-only
                # touch of an already-empty file
                client.write_object_bytes(key, b"")
                actions.append(f"upload {key}")
    if has_old and (not has_new or is_rename):
        hit = find_mapping(mappings, old_path)
        if hit and old_path != hit[0]:
            client = open_remote(hit[1]["spec"])
            key = remote_key_for(hit[0], hit[1], old_path)
            if ev.old_entry.is_directory:
                for k in client.list_keys(key + "/"):
                    client.delete_object(k)
            else:
                client.delete_object(key)
            actions.append(f"delete {key}")
    return "; ".join(actions) if actions else None
