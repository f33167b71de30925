"""FTP gateway over the filer.

Reference: weed/ftpd/ftp_server.go is an 81-line skeleton around
fclairamb/ftpserverlib whose AuthUser returns (nil, nil) — it was never
wired into the command table. This package speaks the FTP protocol
directly (RFC 959 control channel + passive-mode data connections) over
a remote FilerClient, so it is a WORKING gateway: USER/PASS, PWD, CWD,
CDUP, TYPE, PASV, EPSV, LIST, NLST, RETR, STOR, DELE, MKD, RMD, RNFR/
RNTO, SIZE, MDTM, FEAT, SYST, NOOP, QUIT.

The port's copy of seaweedfs_tpu/ftpd/, unchanged.
"""

from .ftp_server import FtpServer

__all__ = ["FtpServer"]
