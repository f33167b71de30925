"""The port's host CRC32C (its own C library and the Python oracle), its
GF(2) formulation, and K3's plain version (ops/crc_torch.py) against the
JAX package's ops/crc32c.py, bit for bit."""

import ctypes
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import crc32c as ref
from seaweedfs_tpu_torch.ops import _build, crc32c, crc_cuda, crc_torch

LENGTHS = [0, 1, 7, 8, 9, 15, 16, 17, 511, 512, 513, 1087, 9000]


def _msgs(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.uint8) for n in LENGTHS]


def test_check_value():
    assert crc32c.crc32c(b"123456789") == 0xE3069283
    assert crc32c._soft_crc32c(b"123456789") == 0xE3069283
    assert crc32c.crc32c(b"") == 0 == ref.crc32c(b"")


@pytest.mark.parametrize("kind", ["bytes", "bytearray", "memoryview", "ndarray"])
def test_host_crc_matches_reference(kind):
    for m in _msgs(1):
        raw = m.tobytes()
        data = {"bytes": raw, "bytearray": bytearray(raw),
                "memoryview": memoryview(raw), "ndarray": m}[kind]
        want = ref.crc32c(raw)
        assert crc32c.crc32c(data) == want == crc32c._soft_crc32c(data)


def test_host_crc_chains_like_reference():
    data = bytes(range(256)) * 5
    for cut in (0, 1, 77, 640, len(data)):
        v = crc32c.crc32c(data[:cut])
        assert crc32c.crc32c(data[cut:], v) == ref.crc32c(data) == \
            ref.crc32c(data[cut:], ref.crc32c(data[:cut]))


@pytest.mark.parametrize("sse42", [True, False])
def test_c_library_both_paths(monkeypatch, sse42):
    """The SSE4.2 loop and the slicing-by-8 table loop agree with the
    reference; the table build is forced by hiding sse4_2."""
    if sse42 and "sse4_2" not in _build.cpu_flags():
        pytest.skip("this CPU has no SSE4.2")
    if not sse42:
        monkeypatch.setattr(_build, "cpu_flags", lambda: set())
    lib = _build.build_host("crc32c_host").lib
    lib.crc32c_init()
    lib.crc32c_hw.restype = ctypes.c_int
    lib.crc32c_update.argtypes = [ctypes.c_uint32, ctypes.c_void_p,
                                  ctypes.c_size_t]
    lib.crc32c_update.restype = ctypes.c_uint32
    assert lib.crc32c_hw() == int(sse42)
    for m in _msgs(2):
        raw = m.tobytes()
        assert lib.crc32c_update(0xFFFFFFFF, raw, len(raw)) ^ 0xFFFFFFFF == \
            ref.crc32c(raw)


@pytest.mark.parametrize("k", [1, 8, 64, 512])
def test_chunk_matrices_equal(k):
    s, c = crc32c.chunk_matrices(k)
    rs, rc = ref.chunk_matrices(k)
    np.testing.assert_array_equal(s, rs)
    np.testing.assert_array_equal(c, rc)


def test_step_matrices_and_powers_equal():
    for got, want in zip(crc32c._a_d(), ref._a_d()):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(crc32c._a_pow2(), ref._a_pow2()):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(crc32c._table(), ref._table())


def test_zero_prefix_correction_and_finalize_equal():
    rng = np.random.default_rng(3)
    lengths = np.concatenate([np.array(LENGTHS),
                              rng.integers(0, 1 << 40, 64)])
    np.testing.assert_array_equal(crc32c.zero_prefix_correction(lengths),
                                  ref.zero_prefix_correction(lengths))
    raw = rng.integers(0, 1 << 32, lengths.size, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(crc32c.finalize(raw, lengths),
                                  ref.finalize(raw, lengths))


def _ref_states(blocks, chunk):
    fn = jax.jit(lambda b: ref.device_crc_states(b, chunk))
    return np.asarray(fn(blocks)).astype(np.uint32)


@pytest.mark.parametrize("chunk", [64, 512])
@pytest.mark.parametrize("length", [0, 512, 1024, 4096])
def test_plain_states_match_device_crc_states(chunk, length):
    rng = np.random.default_rng(length + chunk)
    blocks = rng.integers(0, 256, (5, length), dtype=np.uint8)
    blocks[1] = 0
    blocks[2] = 0xFF
    got = crc_torch.crc_states(torch.from_numpy(blocks), chunk)
    assert got.dtype == torch.int64 and tuple(got.shape) == (5,)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  _ref_states(blocks, chunk))


@pytest.mark.parametrize("chunk", [64, 512])
def test_plain_states_finalize_to_needle_crcs(chunk):
    """Left-padded needles of lengths 0, 1, 511, 512, 513 ...: K3's plain
    version, finalized, equals the host CRC and the reference's states."""
    lengths = [0, 1, 511, 512, 513, 1000, 1024]
    rng = np.random.default_rng(chunk)
    width = 1024
    blocks = np.zeros((len(lengths), width), dtype=np.uint8)
    msgs = []
    for i, n in enumerate(lengths):
        m = rng.integers(0, 256, n, dtype=np.uint8)
        msgs.append(m)
        blocks[i, width - n:] = m
    raw = crc_torch.crc_states(torch.from_numpy(blocks), chunk).numpy()
    np.testing.assert_array_equal(raw.astype(np.uint32),
                                  _ref_states(blocks, chunk))
    vals = crc32c.finalize(raw, np.array(lengths))
    assert [int(v) for v in vals] == [ref.crc32c(m.tobytes()) for m in msgs]


def test_k3_wrapper_on_cpu_is_the_plain_version():
    blocks = np.random.default_rng(9).integers(0, 256, (3, 1024), np.uint8)
    x = torch.from_numpy(blocks)
    np.testing.assert_array_equal(crc_cuda.crc_states(x).numpy(),
                                  crc_torch.crc_states(x, 512).numpy())
    assert crc_cuda.crc_states(x[:, :0]).tolist() == [0, 0, 0]


def test_k3_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="multiple of 512"):
        crc_cuda.crc_states(torch.zeros((2, 256), dtype=torch.uint8))
    with pytest.raises(ValueError, match="uint8"):
        crc_cuda.crc_states(torch.zeros((2, 512), dtype=torch.int32))
    with pytest.raises(ValueError, match="uint8"):
        crc_cuda.crc_states(torch.zeros(512, dtype=torch.uint8))
    with pytest.raises(TypeError):
        crc_cuda.crc_states(np.zeros((2, 512), np.uint8))
    with pytest.raises(ValueError, match="not a multiple of the 64-byte"):
        crc_torch.crc_states(torch.zeros((1, 100), dtype=torch.uint8), 64)


_NO_BUILD = r"""
import importlib, pkgutil, sys
import seaweedfs_tpu_torch
from seaweedfs_tpu_torch.ops import _build
calls = []
def refuse(*args, **kwargs):
    calls.append(args)
    raise RuntimeError("built at import")
_build._compile = refuse
for m in pkgutil.walk_packages(seaweedfs_tpu_torch.__path__, "seaweedfs_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
print("CALLS", len(calls))
"""


def test_importing_the_port_builds_nothing():
    root = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", _NO_BUILD], capture_output=True,
                         text=True, timeout=120, cwd=str(root))
    assert out.returncode == 0, out.stderr
    assert "CALLS 0" in out.stdout, out.stdout
