"""remote.* shell commands (reference command_remote_mount.go,
command_remote_cache.go, command_remote_uncache.go,
command_remote_unmount.go, command_remote_configure.go). All drive a
REMOTE filer through FilerClient — the same seam the standalone gateways
use — so the shell needs no in-process filer.

The port's copy of seaweedfs_tpu/shell/remote_commands.py: the seven
remote.* commands and mount.configure, with the same flags and lines.
Each command closes the FilerClient it opened (the reference's stay open
until the shell exits), and mount.configure dials the port's
mount/control.py, which speaks the reference's bytes, so either package's
shell configures either package's mount."""

from __future__ import annotations

import argparse
import contextlib

from .commands import CommandEnv, command


def _remote_parser(prog: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog)
    p.add_argument("-filer", default="")
    return p


@contextlib.contextmanager
def _fc(env: CommandEnv, opt_filer: str):
    from ..client.filer_client import FilerClient
    from .fs_commands import _filer_addr
    fc = FilerClient(_filer_addr(env, opt_filer))
    try:
        yield fc
    finally:
        fc.close()


@command("remote.mount", "-dir /path -remote spec [-prefix p]: mount a "
         "remote bucket path into the namespace")
def cmd_remote_mount(env: CommandEnv, args):
    from ..remote import mount_remote

    p = _remote_parser("remote.mount")
    p.add_argument("-dir", required=True)
    p.add_argument("-remote", required=True,
                   help="remote spec, e.g. local:///data or s3 endpoint spec")
    p.add_argument("-prefix", default="")
    opt = p.parse_args(args)
    with _fc(env, opt.filer) as fc:
        n = mount_remote(fc, opt.dir, opt.remote, opt.prefix)
    env.println(f"mounted {opt.remote} at {opt.dir}: {n} entries")


@command("remote.unmount", "-dir /path: detach a remote mount")
def cmd_remote_unmount(env: CommandEnv, args):
    from ..remote import unmount_remote

    p = _remote_parser("remote.unmount")
    p.add_argument("-dir", required=True)
    opt = p.parse_args(args)
    with _fc(env, opt.filer) as fc:
        unmount_remote(fc, opt.dir)
    env.println(f"unmounted {opt.dir}")


@command("remote.cache", "-path /file: pull a remote-mounted entry's bytes "
         "into local volumes")
def cmd_remote_cache(env: CommandEnv, args):
    from ..remote import cache_remote

    p = _remote_parser("remote.cache")
    p.add_argument("-path", required=True)
    opt = p.parse_args(args)
    with _fc(env, opt.filer) as fc:
        cache_remote(fc, opt.path)
    env.println(f"cached {opt.path}")


@command("remote.uncache", "-path /file: drop local chunks, keep the remote "
         "reference")
def cmd_remote_uncache(env: CommandEnv, args):
    from ..remote import uncache_remote

    p = _remote_parser("remote.uncache")
    p.add_argument("-path", required=True)
    opt = p.parse_args(args)
    with _fc(env, opt.filer) as fc:
        uncache_remote(fc, opt.path)
    env.println(f"uncached {opt.path}")


@command("remote.configure", "list configured remote mounts")
def cmd_remote_configure(env: CommandEnv, args):
    from ..remote.remote_mount import _load_mappings

    opt = _remote_parser("remote.configure").parse_args(args)
    with _fc(env, opt.filer) as fc:
        mappings = _load_mappings(fc)
    if not mappings:
        env.println("(no remote mounts)")
    for directory, m in sorted(mappings.items()):
        env.println(f"{directory} -> {m['spec']} prefix={m.get('prefix', '')!r}")


@command("remote.meta.sync", "-dir /path: re-import the remote listing "
         "(pick up new/changed objects)")
def cmd_remote_meta_sync(env: CommandEnv, args):
    from ..remote import mount_remote
    from ..remote.remote_mount import _load_mappings

    p = _remote_parser("remote.meta.sync")
    p.add_argument("-dir", required=True)
    opt = p.parse_args(args)
    with _fc(env, opt.filer) as fc:
        m = _load_mappings(fc).get(opt.dir)
        if m is None:
            env.println(f"{opt.dir} is not a remote mount")
            return
        n = mount_remote(fc, opt.dir, m["spec"], m.get("prefix", ""))
    env.println(f"meta-synced {opt.dir}: {n} entries")


@command("mount.configure", "-dir /mnt [-quotaMB N]: set the quota on a "
         "live kernel mount (local machine only)")
def cmd_mount_configure(env: CommandEnv, args):
    """Reference command_mount_configure.go: dials the mount process's
    local control socket (derived from the mount directory) and applies
    CollectionCapacity."""
    from ..mount.control import configure_mount

    p = argparse.ArgumentParser(prog="mount.configure")
    p.add_argument("-dir", required=True)
    p.add_argument("-quotaMB", type=int, default=0)
    opt = p.parse_args(args)
    resp = configure_mount(opt.dir, opt.quotaMB << 20)
    if not resp.get("ok"):
        env.println(f"mount.configure failed: {resp.get('error')}")
        return
    env.println(f"{opt.dir}: collection capacity "
                f"{resp['collection_capacity'] >> 20} MB")


@command("remote.mount.buckets", "[-remote name] [-bucketPattern p] "
         "[-apply]: mount every bucket of a configured remote")
def cmd_remote_mount_buckets(env: CommandEnv, args):
    """Reference command_remote_mount_buckets.go: list the remote's
    buckets, mount each under /buckets/<name>; dry-run without -apply."""
    p = _remote_parser("remote.mount.buckets")
    p.add_argument("-remote", default="",
                   help="remote spec, e.g. s3:http://host:port[?ak:sk] "
                        "or local:/dir (bucket = subdir)")
    p.add_argument("-bucketPattern", default="")
    p.add_argument("-apply", action="store_true")
    opt = p.parse_args(args)
    with _fc(env, opt.filer) as fc:
        _mount_buckets(env, fc, opt)


def _mount_buckets(env: CommandEnv, fc, opt) -> None:
    import fnmatch

    from ..remote import mount_remote
    from ..remote.remote_mount import _load_mappings
    from ..storage.backend import bucket_spec, open_remote
    if not opt.remote:
        mappings = _load_mappings(fc)
        if not mappings:
            env.println("(no remote mounts)")
        for directory, m in sorted(mappings.items()):
            env.println(f"{directory} -> {m['spec']}")
        return
    client = open_remote(opt.remote if ":" in opt.remote
                         else f"local:{opt.remote}")
    buckets = client.list_buckets()
    if opt.bucketPattern:
        buckets = [b for b in buckets
                   if fnmatch.fnmatch(b, opt.bucketPattern)]
    for b in buckets:
        env.println(f"bucket {b} -> /buckets/{b}")
        if opt.apply:
            n = mount_remote(fc, f"/buckets/{b}", bucket_spec(opt.remote, b),
                             "")
            env.println(f"  mounted ({n} entries)")
    if not opt.apply:
        env.println(f"{len(buckets)} bucket(s); pass -apply to mount")
