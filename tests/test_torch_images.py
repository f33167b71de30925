"""The port's image ops (seaweedfs_tpu_torch/images/) against the JAX
package's, byte for byte on the same interpreter and Pillow: should_resize,
resized in every mode and fix_jpeg_orientation on seeded PNG, JPEG (with
EXIF orientations), GIF and WEBP images; then resized GETs from a port
volume server equal to a JAX server's for the same needles — gzip-stored
ones, a Range header that the resize turns off, and, once both volumes are
sealed at RS(4,2) with two shards lost, degraded EC reads whose needles the
port reconstructs. Exact comparisons; no tolerance applies."""

import gzip
import io
import struct
import zlib

import numpy as np
import pytest
import requests

import test_torch_volume_server as tvs
from seaweedfs_tpu import images as ref_images
from seaweedfs_tpu.pb import volume_server_pb2 as vpb
from seaweedfs_tpu_torch import images
from seaweedfs_tpu_torch.images import resize
from seaweedfs_tpu_torch.storage.types import file_id
from seaweedfs_tpu_torch.utils import retry

PIL = pytest.importorskip("PIL.Image")


def png_bytes(rgb: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of `rgb` [h, w, 3], made with zlib and struct."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def smooth_rgb(seed: int, w: int, h: int) -> np.ndarray:
    """Seeded smooth content: a few sinusoids per channel."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        fx, fy, ph = rng.uniform(0.5, 4.0), rng.uniform(0.5, 4.0), \
            rng.uniform(0, 6.3)
        out[..., c] = 127.5 + 127.5 * np.sin(2 * np.pi * (fx * x / w
                                                          + fy * y / h) + ph)
    return out.astype(np.uint8)


def encoded(fmt: str, seed: int, w: int, h: int, orientation: int = 0) -> bytes:
    if fmt == "png":
        return png_bytes(smooth_rgb(seed, w, h))
    img = PIL.fromarray(smooth_rgb(seed, w, h))
    buf = io.BytesIO()
    kw = {}
    if orientation:
        exif = PIL.Exif()
        exif[0x0112] = orientation
        kw["exif"] = exif.tobytes()
    img.save(buf, format={"jpg": "JPEG", "gif": "GIF",
                          "webp": "WEBP"}[fmt], **kw)
    return buf.getvalue()


def test_png_writer_reads_back_through_pillow():
    rgb = smooth_rgb(1, 64, 48)
    assert np.array_equal(np.asarray(PIL.open(io.BytesIO(png_bytes(rgb)))),
                          rgb)


@pytest.mark.parametrize("ext,query", [
    (".png", {"width": "128", "height": "128"}),
    (".JPG", {"width": "200", "mode": "fit"}),
    (".jpeg", {"height": "7"}),
    (".gif", {}), (".webp", {"width": "0", "height": "0"}),
    (".txt", {"width": "10"}), ("", {"width": "10"}),
    (".png", {"width": "ten"}), (".png", {"width": "-4"}),
])
def test_should_resize_equals_reference(ext, query):
    assert images.should_resize(ext, query) == \
        ref_images.should_resize(ext, query)


_RESIZES = [(128, 128, ""), (200, 0, "fit"), (0, 100, ""), (300, 100, "fill"),
            (300, 100, "fit"), (160, 120, ""), (2000, 0, ""), (0, 0, ""),
            (640, 480, "fill"), (64, 64, "fit")]


@pytest.mark.parametrize("fmt,w,h", [("png", 640, 480), ("jpg", 320, 200),
                                     ("gif", 100, 150), ("webp", 300, 300)])
def test_resized_equals_reference(fmt, w, h):
    data = encoded(fmt, seed=w + h, w=w, h=h)
    ext = "." + fmt
    for width, height, mode in _RESIZES:
        got = images.resized(ext, data, width, height, mode)
        assert got == ref_images.resized(ext, data, width, height, mode), \
            (fmt, width, height, mode)
    assert images.resized(ext, b"not an image", 10, 10) == b"not an image"


@pytest.mark.parametrize("orientation", [0, 1, 3, 6, 8])
def test_fix_jpeg_orientation_equals_reference(orientation):
    data = encoded("jpg", seed=orientation, w=96, h=64,
                   orientation=orientation)
    got = images.fix_jpeg_orientation(data)
    assert got == ref_images.fix_jpeg_orientation(data)
    if orientation in (6, 8):
        assert PIL.open(io.BytesIO(got)).size == (64, 96)
    elif orientation in (0, 1):
        assert got == data  # nothing to bake: the stored bytes
    assert images.fix_jpeg_orientation(b"junk") == b"junk"


def test_without_pillow_the_ops_are_identities(monkeypatch):
    monkeypatch.setattr(resize, "HAVE_PIL", False)
    data = encoded("png", 3, 64, 64)
    assert images.resized(".png", data, 10, 10) == data
    assert images.fix_jpeg_orientation(data) == data


@pytest.fixture(autouse=True)
def _port_breakers():
    retry.reset_breakers()
    yield
    retry.reset_breakers()


def _image_uploads(seed=61):
    """(fid, data, headers, query) of image needles: PNGs stored plain and
    gzip-stored, JPEGs with EXIF orientation 6, a GIF, and a text needle."""
    out = []
    rng = np.random.default_rng(seed)
    specs = [("png", 160, 120, 0, False), ("png", 120, 160, 0, True),
             ("jpg", 200, 150, 6, False), ("jpg", 150, 100, 6, True),
             ("gif", 90, 60, 0, False), ("png", 64, 64, 0, False),
             ("jpg", 130, 90, 0, False), ("png", 300, 90, 0, True)]
    for i, (fmt, w, h, orient, gz) in enumerate(specs, 1):
        data = encoded(fmt, seed + i, w, h, orient)
        headers = {"Content-Type": f"image/{'jpeg' if fmt == 'jpg' else fmt}"}
        if gz:
            data = gzip.compress(data)
            headers["Content-Encoding"] = "gzip"
        out.append((file_id(tvs.VID, i, int(rng.integers(1, 1 << 32))), data,
                    headers, f"?name=pic{i}.{fmt}"))
    out.append((file_id(tvs.VID, 99, 0x7E57), b"plain text" * 40,
                {"Content-Type": "text/plain"}, "?name=notes.txt"))
    return out


_GET_QUERIES = ["?width=128&height=128", "?width=200&mode=fit",
                "?width=100&height=40&mode=fill", "?height=50",
                "?width=2000", ""]


def _resized_gets_equal(urls, uploads):
    n = 0
    for fid, data, headers, _ in uploads:
        for q in _GET_QUERIES:
            for hdr in ({}, {"Accept-Encoding": "gzip"},
                        {"Range": "bytes=0-99"}):
                port_ans, ref_ans = (tvs._get(u, fid + q, **hdr)
                                     for u in urls)
                assert port_ans == ref_ans, (fid, q, hdr)
                n += port_ans[0] == 200 and bool(q)
    return n


def _host_resize_of(uploads, fid, q):
    """images.resized applied on the host to the stored needle."""
    for f, data, headers, query in uploads:
        if f == fid:
            break
    if headers.get("Content-Encoding") == "gzip":
        data = gzip.decompress(data)
    ext = "." + query.rsplit(".", 1)[1]
    params = dict(kv.split("=") for kv in q.lstrip("?").split("&"))
    w, h, mode, do = images.should_resize(ext, params)
    if ext in (".jpg", ".jpeg"):
        data = images.fix_jpeg_orientation(data)
    return images.resized(ext, data, w, h, mode)


def test_resized_gets_against_reference_plain_and_degraded_ec(tmp_path):
    uploads = _image_uploads()
    vs, ref = tvs._twins(tmp_path, uploads)
    stub = tvs._stub(ref)
    try:
        assert _resized_gets_equal((vs.url, ref.url), uploads) > 20
        # a resize turns Range off and answers the resized body in full
        fid = uploads[0][0]
        st, body, hdrs = tvs._get(vs.url, fid + "?width=80&height=80",
                                  Range="bytes=0-9")
        assert st == 200 and hdrs["Content-Range"] is None
        assert body == _host_resize_of(uploads, fid, "?width=80&height=80")
        assert PIL.open(io.BytesIO(body)).size == (80, 80)

        vs.volume_mark_readonly(tvs.VID)
        vs.volume_ec_shards_generate(tvs.VID)
        vs.volume_ec_shards_mount(tvs.VID)
        vs.volume_delete(tvs.VID)
        vs.volume_ec_shards_delete(tvs.VID, shard_ids=list(tvs.LOST))
        for method, req, resp in (
                ("VolumeMarkReadonly",
                 vpb.VolumeMarkReadonlyRequest(volume_id=tvs.VID),
                 vpb.VolumeMarkReadonlyResponse),
                ("VolumeEcShardsGenerate",
                 vpb.VolumeEcShardsGenerateRequest(volume_id=tvs.VID),
                 vpb.VolumeEcShardsGenerateResponse),
                ("VolumeEcShardsMount",
                 vpb.VolumeEcShardsMountRequest(volume_id=tvs.VID),
                 vpb.VolumeEcShardsMountResponse),
                ("VolumeDelete", vpb.VolumeDeleteRequest(volume_id=tvs.VID),
                 vpb.VolumeDeleteResponse),
                ("VolumeEcShardsDelete", vpb.VolumeEcShardsDeleteRequest(
                    volume_id=tvs.VID, shard_ids=list(tvs.LOST)),
                 vpb.VolumeEcShardsDeleteResponse)):
            stub.call(method, req, resp, timeout=60)
        before = vs.read_stats.get("reconstructs", 0)
        assert _resized_gets_equal((vs.url, ref.url), uploads) > 20
        assert vs.read_stats["reconstructs"] > before
        for fid, *_ in uploads[:-1]:
            for q in _GET_QUERIES[:2]:
                st, body, _ = tvs._get(vs.url, fid + q)
                assert (st, body) == (200, _host_resize_of(uploads, fid, q))
    finally:
        vs.stop()
        ref.stop()


def test_resized_get_without_pillow_serves_stored_bytes(tmp_path,
                                                        monkeypatch):
    uploads = _image_uploads(seed=62)[:3]
    vs = tvs._port(tmp_path / "port")
    try:
        vs.allocate_volume(tvs.VID)
        for fid, data, headers, query in uploads:
            assert requests.post(f"http://{vs.url}/{fid}{query}", data=data,
                                 headers=headers, timeout=10).status_code == 201
        monkeypatch.setattr(resize, "HAVE_PIL", False)
        for fid, data, headers, _ in uploads:
            st, body, _ = tvs._get(vs.url, fid + "?width=32&height=32")
            want = gzip.decompress(data) \
                if headers.get("Content-Encoding") else data
            assert (st, body) == (200, want)
    finally:
        vs.stop()
