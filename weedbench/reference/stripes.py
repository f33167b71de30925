"""The EC stripe map (SeaweedFS ec_locate.go LocateData and
ToShardIdAndOffset): a volume's bytes striped row-major over d data
shards, rows of d large blocks while more than d large blocks remain, then
rows of d small blocks, the last zero-padded. Adjacent intervals of one
shard in one logical read form one run (one read of that shard)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Geometry:
    d: int
    p: int
    large_block: int = 1 << 30
    small_block: int = 1 << 20

    def large_rows(self, dat_size: int) -> int:
        rows, remaining = 0, dat_size
        while remaining > self.large_block * self.d:
            rows += 1
            remaining -= self.large_block * self.d
        return rows

    def shard_size(self, dat_size: int) -> int:
        nl = self.large_rows(dat_size)
        rest = dat_size - nl * self.large_block * self.d
        per_row = self.small_block * self.d
        return nl * self.large_block + -(-rest // per_row) * self.small_block

    def block_left(self, dat_size: int, offset: int) -> int:
        """Bytes from shard offset `offset` to the end of its block."""
        nl = self.large_rows(dat_size)
        if offset < nl * self.large_block:
            return self.large_block - offset % self.large_block
        return (self.small_block
                - (offset - nl * self.large_block) % self.small_block)

    def logical(self, dat_size: int, shard: int, offset: int) -> int:
        """The volume offset that data shard `shard` holds at `offset`."""
        nl = self.large_rows(dat_size)
        if offset < nl * self.large_block:
            row, inner = divmod(offset, self.large_block)
            return (row * self.d + shard) * self.large_block + inner
        row, inner = divmod(offset - nl * self.large_block, self.small_block)
        return (nl * self.d * self.large_block
                + (row * self.d + shard) * self.small_block + inner)


def runs(geo: Geometry, dat_size: int, offset: int,
         length: int) -> "list[tuple[int, int, int]]":
    """(shard, shard offset, bytes) of each run of [offset, offset+length)."""
    nl = geo.large_rows(dat_size)
    large_zone = nl * geo.large_block * geo.d
    out: "list[list[int]]" = []
    last: "dict[int, list[int]]" = {}
    pos, remaining = offset, length
    while remaining > 0:
        if pos < large_zone:
            block, inner = divmod(pos, geo.large_block)
            take = min(remaining, geo.large_block - inner)
            shard, row = block % geo.d, block // geo.d
            soff = row * geo.large_block + inner
        else:
            block, inner = divmod(pos - large_zone, geo.small_block)
            take = min(remaining, geo.small_block - inner)
            shard, row = block % geo.d, block // geo.d
            soff = nl * geo.large_block + row * geo.small_block + inner
        run = last.get(shard)
        if run is not None and run[1] + run[2] == soff:
            run[2] += take
        else:
            run = last[shard] = [shard, soff, take]
            out.append(run)
        pos += take
        remaining -= take
    return [tuple(r) for r in out]


def first_shard(geo: Geometry, dat_size: int, offsets) -> "np.ndarray":
    """The shard of the first byte at each of `offsets` (the first run's
    shard of a read starting there)."""
    import numpy as np
    off = np.asarray(offsets, np.int64)
    nl = geo.large_rows(dat_size)
    large_zone = nl * geo.large_block * geo.d
    block = np.where(off < large_zone, off // geo.large_block,
                     nl * geo.d + (off - large_zone) // geo.small_block)
    return block % geo.d
