"""Phase 24 of chip_smoke.py on the CPU at a small size (12 files of 1-64
KiB and one of 1-2 MiB in each of the remote and WeedFS trees, a 2 MiB
one through WeedFS, 4 small and 1 large through FTP; 64 KiB EC small
blocks): the remote
mount through the shell (read-through, cache, meta.sync, the
filer.remote.sync verb), WeedFS over a FilerClient with the quota set
through the control socket, the ftp verb, then ec.encode, r1 lost and
every file read back through WeedFS, FTP and the filer's HTTP, uncache
and unmount; every step's checks hold and the reads with r1 lost
reconstruct as many intervals as one-stripe K1 calls."""

import numpy as np


def test_gateways_round_trip_of_chip_smoke_on_cpu(tmp_path):
    import chip_smoke
    import torch
    res = chip_smoke.gateways_round_trip(np, torch, str(tmp_path), 7, "cpu",
                                         12, 1, 2, 4, 1, 64, device="cpu",
                                         small_block=1 << 16, large_mb=2)
    assert res["reconstructs"] == len(res["widths"]) > 0
    assert res["fuse_write"] > 0 and res["retr"] > 0 and res["cache_s"] > 0
