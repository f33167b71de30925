"""Per-needle statuses of a bulk read — the part of the JAX package's
storage/bulk.py that Volume.read_needles returns. The SWBF/SWBR/SWBG wire
frames come with the volume server."""

from __future__ import annotations

READ_OK = 0
READ_NOT_FOUND = 1     # missing/deleted — a definitive per-needle miss
READ_ERROR = 2         # IO/crc/cookie failure — client retries elsewhere
READ_OVERFLOW = 3      # needle didn't fit the frame's byte budget —
                       # client re-fetches it per-needle
