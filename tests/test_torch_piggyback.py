"""The port's piggybacked-RS codec (seaweedfs_tpu_torch/ops/piggyback.py)
against the JAX package's (seaweedfs_tpu/ops/piggyback.py on its numpy
backend), byte for byte: encode, reconstruct under data and parity losses,
repair plans and byte costing at (4,2), (5,3), (10,4) and (14,2). The port
runs its inner TorchCoder with device="cpu" (the plain PyTorch version of
kernel K1); a stand-in inner coder whose outputs are pending results (with
`wait()`, like the card's DeviceResult) shows every inner output goes
through `host_result`."""

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops.coder import repair_read_bytes as ref_repair_read_bytes
from seaweedfs_tpu.ops.piggyback import PiggybackCoder as RefPiggyback
from seaweedfs_tpu.ops.piggyback import partition_groups as ref_groups
from seaweedfs_tpu_torch.ops import coder as coder_mod
from seaweedfs_tpu_torch.ops.coder import NumpyCoder, TorchCoder, host_result
from seaweedfs_tpu_torch.ops.piggyback import PiggybackCoder, partition_groups

GEOMETRIES = [(4, 2), (5, 3), (10, 4), (14, 2)]


def _data(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _losses(d, p, seed):
    """Loss patterns: data only, parity only (piggybacked ones included),
    mixed, and a seeded draw; each at most p shards."""
    n = d + p
    rng = np.random.default_rng(seed)
    pats = [(0,), (d - 1,), (d,), (n - 1,), tuple(range(d, n))[:p],
            (0, n - 1)[:p], (1, d + 1)[:p],
            tuple(sorted(rng.choice(n, p, replace=False).tolist()))]
    return list(dict.fromkeys(pats))


class Pending:
    """A result still in flight: hands its array over on wait(), has no
    __array__ (np.asarray of it is a 0-d object array)."""

    def __init__(self, arr):
        self._arr = arr

    def wait(self):
        return self._arr


class PendingCoder(NumpyCoder):
    """NumpyCoder whose outputs come back as Pending results."""

    def encode(self, data):
        return Pending(super().encode(data))

    def reconstruct(self, survivors, present, wanted):
        return Pending(super().reconstruct(survivors, present, wanted))


@pytest.mark.parametrize("d,p", GEOMETRIES)
def test_partition_groups_match_reference(d, p):
    assert partition_groups(d, p) == ref_groups(d, p)
    assert PiggybackCoder(d, p, device="cpu").groups == ref_groups(d, p)
    for f in range(d):
        assert PiggybackCoder(d, p, device="cpu").group_of(f) == \
            RefPiggyback(d, p).group_of(f)


@pytest.mark.parametrize("d,p", GEOMETRIES)
def test_encode_matches_reference(d, p):
    port, ref = PiggybackCoder(d, p, device="cpu"), RefPiggyback(d, p)
    assert isinstance(port.inner, TorchCoder) and port.inner.device.type == "cpu"
    for shape in [(d, 64), (3, d, 130)]:
        data = _data(shape, d * 7 + len(shape))
        got = port.encode(data)
        assert isinstance(got, np.ndarray) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref.encode(data))


@pytest.mark.parametrize("d,p", GEOMETRIES)
def test_reconstruct_matches_reference(d, p):
    port, ref = PiggybackCoder(d, p, device="cpu"), RefPiggyback(d, p)
    data = _data((2, d, 96), d + p)
    shards = np.concatenate([data, ref.encode(data)], axis=1)
    for lost in _losses(d, p, d):
        present = tuple(i for i in range(d + p) if i not in lost)
        surv = shards[:, sorted(present)[:d]]
        got = port.reconstruct(surv, present, lost)
        np.testing.assert_array_equal(got, ref.reconstruct(surv, present, lost))
        np.testing.assert_array_equal(got, shards[:, list(lost)])
        np.testing.assert_array_equal(
            port.reconstruct(surv[0], present, lost), shards[0, list(lost)])


@pytest.mark.parametrize("d,p", GEOMETRIES)
def test_repair_plan_and_costing_match_reference(d, p):
    port, ref = PiggybackCoder(d, p, device="cpu"), RefPiggyback(d, p)
    n = d + p
    for shard_size in (1000, 1001, 4096):
        for lost in _losses(d, p, n) + [(1, 2)]:
            present = tuple(i for i in range(n) if i not in lost)
            assert port.repair_plan(present, lost, shard_size) == \
                ref.repair_plan(present, lost, shard_size)
            assert coder_mod.repair_read_bytes("piggyback", d, p, lost, shard_size) \
                == ref_repair_read_bytes("piggyback", d, p, lost, shard_size)
    # a survivor the plan needs is itself missing: no ranged plan
    present = tuple(i for i in range(n) if i not in (0, d))
    assert port.repair_plan(present, (0,), 1000) is None


def test_rs_10_4_single_loss_reads_0_65_to_0_70_of_plain_rs():
    for f in range(10):
        cost = coder_mod.repair_read_bytes("piggyback", 10, 4, [f], 1000)
        assert 0.65 * 10_000 <= cost <= 0.70 * 10_000


def test_refusals_match_reference():
    with pytest.raises(ValueError, match="even"):
        PiggybackCoder(4, 2, device="cpu").encode(_data((4, 7), 0))
    with pytest.raises(ValueError, match="p >= 2"):
        PiggybackCoder(4, 1, device="cpu")


def test_inner_outputs_go_through_host_result():
    """A pending inner result (no __array__) still gives the reference's
    bytes: every inner output is taken through host_result."""
    d, p = 10, 4
    port, ref = PiggybackCoder(d, p, backend="numpy"), RefPiggyback(d, p)
    port.inner = PendingCoder(d, p)
    assert np.asarray(port.inner.encode(_data((d, 8), 1))).dtype == object
    data = _data((2, d, 64), 5)
    np.testing.assert_array_equal(port.encode(data), ref.encode(data))
    shards = np.concatenate([data, ref.encode(data)], axis=1)
    for lost in [(3, 11), (12, 13), (0, 1, 2, 3)]:
        present = tuple(i for i in range(d + p) if i not in lost)
        surv = shards[:, sorted(present)[:d]]
        np.testing.assert_array_equal(port.reconstruct(surv, present, lost),
                                      shards[:, list(lost)])
    assert np.array_equal(host_result(Pending(np.arange(3))), np.arange(3))
    assert np.array_equal(host_result(torch.arange(3, dtype=torch.uint8)),
                          np.arange(3, dtype=np.uint8))


def test_inner_coder_runs_on_the_device_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert PiggybackCoder(4, 2, device="cpu").inner.device.type == "cpu"
    assert isinstance(PiggybackCoder(4, 2, backend="numpy").inner, NumpyCoder)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PiggybackCoder(4, 2)
