"""Daemons with a fault planted under the timed path, for the benchmark's
own tests and its control runs:

    python -m weedbench.faults <fault> <verb> [arguments]

starts `python -m seaweedfs_tpu_torch <verb> ...` with one fault:

    wire_corrupt  the program's own failpoint: one bit flipped in every
                  EC shard interval fetched from a peer
                  (SWTPU_FAILPOINTS ec.shard.read.data=corrupt:1)
    answer_byte   one byte of the data of every 3rd needle a GET reads
                  flipped where the store produces it
"""

from __future__ import annotations

import os
import runpy
import sys


def _answer_byte() -> None:
    from seaweedfs_tpu_torch.storage import store
    orig = store.Store.read_needle

    def read_needle(self, vid, needle_id, *a, **kw):
        n = orig(self, vid, needle_id, *a, **kw)
        if needle_id % 3 == 0 and n.data:
            n.data = bytes([n.data[0] ^ 0x01]) + n.data[1:]
        return n
    store.Store.read_needle = read_needle


FAULTS = {"answer_byte": _answer_byte}


def main(argv) -> None:
    fault, rest = argv[0], argv[1:]
    if fault == "wire_corrupt":
        os.environ["SWTPU_FAILPOINTS"] = "ec.shard.read.data=corrupt:1"
    else:
        FAULTS[fault]()
    sys.argv = ["seaweedfs_tpu_torch", *rest]
    runpy.run_module("seaweedfs_tpu_torch", run_name="__main__",
                     alter_sys=True)


if __name__ == "__main__":
    main(sys.argv[1:])
