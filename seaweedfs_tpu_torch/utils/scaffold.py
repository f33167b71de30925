"""Default TOML templates printed by `scaffold` (reference
command/scaffold.go + command/scaffold/*.toml). Each file is searched on the
config tier chain (utils/config.py): . -> ~/.seaweedfs ->
/usr/local/etc/seaweedfs -> /etc/seaweedfs.

The port's copy of seaweedfs_tpu/utils/scaffold.py: the templates are
byte-equal, since the port reads the same files on the same chain.
"""

SECURITY_TOML = """\
# security.toml — JWT + access control (reference scaffold/security.toml)
# Put this on the config tier chain; CLI flags override.

[jwt.signing]
# key for write tokens the master mints on Assign and volume servers verify
key = ""
expires_after_seconds = 10

[jwt.signing.read]
# optional: also gate reads
key = ""
expires_after_seconds = 10

[guard]
# comma string or list of IPs/CIDRs allowed without a token
white_list = ""

[grpc]
# mutual TLS for the whole gRPC plane (reference security.toml [grpc.*]
# per-component certs; here one trio covers every daemon + client).
# Generate with openssl: a CA plus a cert/key signed by it. The cert's CN
# MUST equal server_name below (clients override the TLS target name to it
# since cluster nodes are dialed by raw IP). Set all three or none —
# a partial section refuses to start rather than run plaintext.
ca = ""
cert = ""
key = ""
server_name = "swtpu"
"""

MASTER_TOML = """\
# master.toml — maintenance cron (reference scaffold/master.toml:11-16)

[master.maintenance]
# shell commands the master leader runs on an interval, one per line
scripts = \"\"\"
volume.fix.replication
ec.rebuild
ec.balance
volume.balance
\"\"\"
sleep_minutes = 17
"""

FILER_TOML = """\
# filer.toml — metadata store backend (reference scaffold/filer.toml)
# spec strings accepted by -store on the filer verb:
#   memory | sqlite:/path/filer.db | logdb:/path/filer.logdb

[filer.options]
store = "sqlite:./filer.db"
"""

REPLICATION_TOML = """\
# replication.toml — filer.replicate sink (reference scaffold/replication.toml)

[sink.filer]
enabled = false
grpcAddress = "localhost:18888"
directory = "/backup"

[sink.local]
enabled = false
directory = "/data/backup"

[sink.s3]
enabled = false
endpoint = "http://localhost:8333"
bucket = "backup"
aws_access_key_id = ""
aws_secret_access_key = ""
"""

NOTIFICATION_TOML = """\
# notification.toml — metadata event fan-out (reference scaffold/notification.toml)

[notification.log]
enabled = false
directory = "/tmp/swtpu-events"

[notification.memory]
enabled = false
"""

SHELL_TOML = """\
# shell.toml — defaults for the admin shell (reference scaffold/shell.toml)

[cluster]
default = "localhost:9333"

[shell]
# default filer for fs.* commands (equivalent to -filer on each command)
filer = ""
"""

TEMPLATES = {
    "security": SECURITY_TOML,
    "master": MASTER_TOML,
    "filer": FILER_TOML,
    "replication": REPLICATION_TOML,
    "notification": NOTIFICATION_TOML,
    "shell": SHELL_TOML,
}
