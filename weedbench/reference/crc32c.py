"""CRC32C (Castagnoli, reflected 0x82F63B78, init and final xor
0xFFFFFFFF), table-driven in NumPy: many messages of one length at once."""

from __future__ import annotations

import numpy as np

POLY = 0x82F63B78


def _table() -> np.ndarray:
    t = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (POLY if c & 1 else 0)
        t[i] = c
    return t


TABLE = _table()


def crc32c_rows(rows: np.ndarray) -> np.ndarray:
    """CRC32C of each row of a [n, L] uint8 array -> [n] uint32."""
    rows = np.asarray(rows, np.uint8)
    s = np.full(rows.shape[0], 0xFFFFFFFF, dtype=np.uint32)
    for j in range(rows.shape[1]):
        s = TABLE[(s ^ rows[:, j]) & 0xFF] ^ (s >> np.uint32(8))
    return s ^ np.uint32(0xFFFFFFFF)
