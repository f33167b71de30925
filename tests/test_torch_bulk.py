"""The port's bulk wire frames (seaweedfs_tpu_torch/storage/bulk.py) against
the JAX package's storage/bulk.py: SWBF put frames, SWBR read requests and
SWBG read responses packed byte for byte alike from the same seeded
inputs, unpacked to the same entries, and refused alike when malformed."""

import struct

import numpy as np
import pytest

from seaweedfs_tpu.storage import bulk as ref
from seaweedfs_tpu_torch.storage import bulk as port


def _entries(n, seed, empty_every=5, gzip_every=3):
    """(key, cookie, data, flags) tuples: gzip flags and empty bodies in."""
    rng = np.random.default_rng(seed)
    cookie = int(rng.integers(0, 1 << 32))
    out = []
    for i in range(n):
        size = 0 if i % empty_every == 0 else int(rng.integers(1, 2048))
        out.append((int(rng.integers(1, 1 << 63)), cookie, rng.bytes(size),
                    0x01 if i % gzip_every == 0 else 0))
    return out


def _results(n, seed):
    rng = np.random.default_rng(seed)
    statuses = (port.READ_OK, port.READ_NOT_FOUND, port.READ_ERROR,
                port.READ_OVERFLOW)
    return [(int(rng.integers(1, 1 << 63)), int(rng.integers(0, 1 << 32)),
             statuses[i % 4], i % 2, rng.bytes(int(rng.integers(0, 900))))
            for i in range(n)]


def test_constants_match_reference():
    for name in ("FRAME_MAGIC", "FRAME_VERSION", "MAX_FRAME_NEEDLES",
                 "READ_REQ_MAGIC", "READ_RESP_MAGIC", "READ_OK",
                 "READ_NOT_FOUND", "READ_ERROR", "READ_OVERFLOW"):
        assert getattr(port, name) == getattr(ref, name), name
    for name in ("_FRAME_HEADER", "_NEEDLE_HEADER", "_READ_REQ_ENTRY",
                 "_READ_RESP_ENTRY"):
        assert getattr(port, name).format == getattr(ref, name).format
    assert issubclass(port.FrameError, ValueError)


@pytest.mark.parametrize("n,seed", [(1, 0), (7, 1), (64, 2), (300, 3)])
def test_put_frame_bytes_and_entries_match_reference(n, seed):
    entries = _entries(n, seed)
    vid = 1000 + seed
    frame = port.pack_frame(vid, entries)
    assert frame == ref.pack_frame(vid, entries)
    got_vid, got = port.unpack_frame(frame)
    ref_vid, want = ref.unpack_frame(frame)
    assert got_vid == ref_vid == vid
    assert [(e.key, e.cookie, e.flags, e.crc, bytes(e.data)) for e in got] \
        == [(e.key, e.cookie, e.flags, e.crc, bytes(e.data)) for e in want]
    assert [(k, c, bytes(e.data), e.flags) for e, (k, c, _, _)
            in zip(port.iter_frame(frame), entries)] == \
        [(k, c, d, f) for k, c, d, f in entries]


def test_put_frame_at_max_needles():
    entries = [(i + 1, 0xABCD, b"" if i % 2 else bytes([i & 0xFF]), 0)
               for i in range(port.MAX_FRAME_NEEDLES)]
    frame = port.pack_frame(9, entries)
    assert frame == ref.pack_frame(9, entries)
    assert len(port.unpack_frame(frame)[1]) == port.MAX_FRAME_NEEDLES
    with pytest.raises(port.FrameError):
        port.pack_frame(9, entries + [(1 << 40, 0xABCD, b"", 0)])
    with pytest.raises(port.FrameError):
        port.pack_frame(9, [])


@pytest.mark.parametrize("n,seed", [(1, 4), (33, 5), (1024, 6)])
def test_read_frames_match_reference(n, seed):
    rng = np.random.default_rng(seed)
    pairs = [(int(rng.integers(1, 1 << 63)), int(rng.integers(0, 1 << 32)))
             for _ in range(n)]
    req = port.pack_read_request(77, pairs)
    assert req == ref.pack_read_request(77, pairs)
    assert port.unpack_read_request(req) == ref.unpack_read_request(req) \
        == (77, pairs)
    results = _results(n, seed)
    resp = port.pack_read_response(77, results)
    assert resp == ref.pack_read_response(77, results)
    got = port.unpack_read_response(resp)
    want = ref.unpack_read_response(resp)
    assert got[0] == want[0] == 77
    assert [(r.key, r.cookie, r.status, r.flags, r.crc, bytes(r.data))
            for r in got[1]] == [(r.key, r.cookie, r.status, r.flags, r.crc,
                                  bytes(r.data)) for r in want[1]]
    # non-OK statuses carry no payload
    assert all(not r.data for r in got[1] if r.status != port.READ_OK)


def _put_frame():
    return port.pack_frame(5, [(1, 7, b"abcdef", 0), (2, 7, b"xyz", 1)])


def _read_request():
    return port.pack_read_request(5, [(1, 7), (2, 7)])


def _read_response():
    return port.pack_read_response(5, [(2, 7, port.READ_NOT_FOUND, 0, b""),
                                       (1, 7, port.READ_OK, 0, b"abcdef")])


_FRAMES = {"put": (_put_frame, "unpack_frame"),
           "read_request": (_read_request, "unpack_read_request"),
           "read_response": (_read_response, "unpack_read_response")}


def _corrupt(kind, how):
    make, _ = _FRAMES[kind]
    body = bytearray(make())
    if how == "short_header":
        return bytes(body[:5])
    if how == "truncated":
        return bytes(body[:-2])
    if how == "bad_magic":
        body[:4] = b"NOPE"
    elif how == "bad_version":
        body[4] = 9
    elif how == "zero_count":
        struct.pack_into("<I", body, 5, 0)
    elif how == "count_over_limit":
        struct.pack_into("<I", body, 5, port.MAX_FRAME_NEEDLES + 1)
    elif how == "trailing":
        body += b"\x00\x01"
    elif how == "bad_crc":
        # flip the last payload byte: its CRC in the header no longer holds
        body[-1] ^= 0xFF
    return bytes(body)


_CASES = [(kind, how) for kind in _FRAMES
          for how in ("short_header", "truncated", "bad_magic", "bad_version",
                      "zero_count", "count_over_limit", "trailing")] + [
    ("put", "bad_crc"), ("read_response", "bad_crc")]


@pytest.mark.parametrize("kind,how", _CASES)
def test_malformed_frames_refused_in_both(kind, how):
    _, fn = _FRAMES[kind]
    body = _corrupt(kind, how)
    with pytest.raises(ref.FrameError) as want:
        getattr(ref, fn)(body)
    with pytest.raises(port.FrameError) as got:
        getattr(port, fn)(body)
    assert str(got.value) == str(want.value)
