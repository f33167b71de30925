"""The port's native CPU coder (ops/native.py over csrc/gf8.cpp, built by
ops/_build.build_host with the host C++ compiler) against the JAX
package's NativeCoder (native/libswtpu.so) and both NumpyCoders, and its
CRC32C against the port's host CRC. Nothing falls back: a library that
cannot be built raises from the coder and from crc32c."""

import numpy as np
import pytest

from seaweedfs_tpu.ops import native as ref_native
from seaweedfs_tpu.ops.coder import NumpyCoder as RefNumpyCoder
from seaweedfs_tpu_torch.ops import _build, crc32c, native
from seaweedfs_tpu_torch.ops.coder import NumpyCoder, get_coder

GEOMETRIES = [(10, 4), (14, 2), (4, 2), (5, 3)]
# widths around the AVX2 body's 32-byte step and its scalar tail
WIDTHS = [1, 31, 32, 33, 1000, 4096 + 7]


def _data(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("d,p", GEOMETRIES)
def test_encode_matches_reference_native_and_numpy(d, p):
    coder = native.NativeCoder(d, p)
    ref = ref_native.NativeCoder(d, p)
    for w in WIDTHS:
        data = _data((3, d, w), w + d)
        got = coder.encode(data)
        np.testing.assert_array_equal(got, ref.encode(data))
        np.testing.assert_array_equal(got, NumpyCoder(d, p).encode(data))
        np.testing.assert_array_equal(got, RefNumpyCoder(d, p).encode(data))
        np.testing.assert_array_equal(coder.encode(data[1]), got[1])


@pytest.mark.parametrize("d,p", GEOMETRIES)
def test_reconstruct_matches_reference_native_and_numpy(d, p):
    coder = native.NativeCoder(d, p)
    ref = ref_native.NativeCoder(d, p)
    rng = np.random.default_rng(d * p)
    data = _data((2, d, 333), d)
    full = np.concatenate([data, coder.encode(data)], axis=1)
    for _ in range(3):
        lost = tuple(sorted(rng.choice(d + p, size=p, replace=False).tolist()))
        present = tuple(i for i in range(d + p) if i not in lost)[:d]
        survivors = full[:, list(present)]
        got = coder.reconstruct(survivors, present, lost)
        np.testing.assert_array_equal(got, full[:, list(lost)])
        np.testing.assert_array_equal(got, ref.reconstruct(survivors, present, lost))
        np.testing.assert_array_equal(
            got, NumpyCoder(d, p).reconstruct(survivors, present, lost))


def test_registry_and_features():
    assert isinstance(get_coder("native", 10, 4), native.NativeCoder)
    feats = native.features()
    have = _build.cpu_flags()
    assert feats == {"avx2": "avx2" in have, "sse42_crc": "sse4_2" in have}
    assert native.load().native_features() == ref_native.load().native_features()


def test_crc32c_matches_port_and_reference():
    rng = np.random.default_rng(7)
    for n in (0, 1, 7, 8, 9, 63, 64, 1000, 65537):
        msg = rng.integers(0, 256, n, dtype=np.uint8)
        want = crc32c.crc32c(msg)
        assert native.crc32c(msg) == native.crc32c(msg.tobytes()) == want
        assert ref_native.crc32c(msg.tobytes()) == want
        cut = n // 3
        assert native.crc32c(msg[cut:], native.crc32c(msg[:cut])) == want
    assert native.crc32c(b"123456789") == 0xE3069283


def test_a_failed_build_raises_everywhere(monkeypatch):
    """The reference degrades to None and to the software CRC; the port
    raises from NativeCoder and from crc32c alike."""
    def no_compiler(name):
        raise RuntimeError("no host C++ compiler found")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(_build, "build_host", no_compiler)
    for call in (lambda: native.NativeCoder(10, 4),
                 lambda: native.crc32c(b"abc"),
                 lambda: get_coder("native", 10, 4)):
        with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
            call()


def test_build_flags_follow_the_cpu(monkeypatch):
    """The native/Makefile rule: -mavx2 -mssse3 with avx2, -msse4.2 with
    sse4_2; a C++ source goes to the C++ compiler with -std=c++17."""
    monkeypatch.setattr(_build, "cpu_flags", lambda: {"avx2", "sse4_2"})
    assert _build.simd_flags() == ("-mavx2", "-mssse3", "-msse4.2")
    monkeypatch.setattr(_build, "cpu_flags", lambda: {"sse4_2"})
    assert _build.simd_flags() == ("-msse4.2",)
    monkeypatch.setattr(_build, "cpu_flags", lambda: set())
    assert _build.simd_flags() == ()
    built = _build.build_host("gf8")
    assert built.path.name.startswith("gf8_") and built.path.parent == _build.BUILD_DIR
    lib = built.lib
    assert lib.native_features() == 0  # the scalar build, no SIMD paths
    data = _data((2, 10, 100), 3)
    out = np.empty((2, 4, 100), np.uint8)
    import ctypes
    lib.rs_apply_batch.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int64]
    mat = np.ascontiguousarray(native.gf8.parity_matrix(10, 4))
    lib.rs_apply_batch(data.ctypes.data, out.ctypes.data, mat.ctypes.data,
                       10, 4, 100, 2)
    np.testing.assert_array_equal(out, NumpyCoder(10, 4).encode(data))
