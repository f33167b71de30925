"""Phase 23 of chip_smoke.py (the message queue and the filer's
notification queues over a cluster of the port) on the CPU at a small
size, through the plain versions of K1 and K3."""

import numpy as np


def test_mq_round_trip_of_chip_smoke_on_cpu(tmp_path):
    """Phase 23 of chip_smoke.py on the CPU at a small size (4,608
    messages of 1 KiB, so each of the four partitions seals a segment; 64
    typed records; 16 KiB EC small blocks): every step's checks hold, B2's
    kill costs the group nothing, the three queues agree, and the replay
    and the mirror with r1 lost reconstruct, one K1 one-stripe call
    each."""
    import chip_smoke
    import torch
    res = chip_smoke.mq_round_trip(np, torch, str(tmp_path), 11, "cpu",
                                   4608, 64, device="cpu",
                                   small_block=1 << 14)
    assert res["reconstructs"] == len(res["widths"]) > 0
    assert res["msgs_s"] > 0 and res["restart_s"] > 0
