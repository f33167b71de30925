"""The port's product-matrix MSR codec (seaweedfs_tpu_torch/ops/
product_matrix.py) against the JAX package's (seaweedfs_tpu/ops/
product_matrix.py on its numpy backend), byte for byte: the grid tables,
encode, reconstruct under data and parity losses, read_closure,
repair_plan, repair_decode and the degraded interval plans and decodes, at
(4,2), (5,3), (10,4) and (14,2). The port runs with device="cpu", where its
GF applies are kernel K1's plain PyTorch version (ops/rs_cuda.gf_apply on a
CPU tensor); a failure there raises, with no numpy fallback."""

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops.coder import repair_read_bytes as ref_repair_read_bytes
from seaweedfs_tpu.ops.product_matrix import ProductMatrixCoder as RefPM
from seaweedfs_tpu_torch.ops import coder as coder_mod
from seaweedfs_tpu_torch.ops import gf8, rs_cuda
from seaweedfs_tpu_torch.ops.product_matrix import ProductMatrixCoder

GEOMETRIES = [(4, 2), (5, 3), (10, 4), (14, 2)]


def _pair(d, p):
    return ProductMatrixCoder(d, p, device="cpu"), RefPM(d, p)


def _data(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _shards(ref, b, s, seed):
    data = _data((b, ref.d, ref.alpha * s), seed)
    return np.concatenate([data, ref.encode(data)], axis=1)


def _losses(d, p, seed):
    n = d + p
    rng = np.random.default_rng(seed)
    pats = [(0,), (d,), (n - 1,), tuple(range(d, n)), tuple(range(p)),
            (1, n - 1)[:p], tuple(sorted(rng.choice(n, p, replace=False).tolist()))]
    return list(dict.fromkeys(pats))


@pytest.mark.parametrize("d,p", GEOMETRIES)
def test_grid_tables_match_reference(d, p):
    g, rg = ProductMatrixCoder(d, p, device="cpu").grid, RefPM(d, p).grid
    assert (g.q, g.t, g.nbar, g.alpha) == (rg.q, rg.t, rg.nbar, rg.alpha)
    for name in ("digits", "unpaired", "pair_node", "pair_layer", "H"):
        np.testing.assert_array_equal(getattr(g, name), getattr(rg, name))
    for f in range(d + p):
        np.testing.assert_array_equal(g.repair_planes(f), rg.repair_planes(f))
        ours, theirs = g.repair_matrices(f), rg.repair_matrices(f)
        assert ours[:2] == theirs[:2]
        np.testing.assert_array_equal(ours[2], theirs[2])


@pytest.mark.parametrize("d,p", GEOMETRIES)
def test_encode_matches_reference(d, p):
    port, ref = _pair(d, p)
    for shape in [(d, port.alpha), (2, d, port.alpha * 3)]:
        data = _data(shape, d + len(shape))
        got = port.encode(data)
        assert isinstance(got, np.ndarray) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref.encode(data))
    np.testing.assert_array_equal(port.encode(_data((d, 0), 0)),
                                  np.zeros((p, 0), np.uint8))
    with pytest.raises(ValueError, match="alpha"):
        port.encode(_data((d, port.alpha + 1), 0))


@pytest.mark.parametrize("d,p", GEOMETRIES)
def test_reconstruct_and_read_closure_match_reference(d, p):
    port, ref = _pair(d, p)
    shards = _shards(ref, 2, 2, d * p)
    for lost in _losses(d, p, d):
        present = tuple(i for i in range(d + p) if i not in lost)
        surv = shards[:, sorted(present)[:d]]
        got = port.reconstruct(surv, present, lost)
        np.testing.assert_array_equal(got, ref.reconstruct(surv, present, lost))
        np.testing.assert_array_equal(got, shards[:, list(lost)])
        wanted = np.array([0, port.alpha // 2, port.alpha - 1])
        closure, fetch = port.read_closure(present, wanted)
        rclosure, rfetch = ref.read_closure(present, wanted)
        np.testing.assert_array_equal(closure, rclosure)
        assert sorted(fetch) == sorted(rfetch)
        for sid in fetch:
            np.testing.assert_array_equal(fetch[sid], rfetch[sid])


def test_reconstruct_length_divisible_by_alpha_27():
    port, ref = _pair(5, 3)
    assert port.alpha == 27
    shards = _shards(ref, 1, 5, 27)[0]
    for lost in [(0, 6, 7), (5, 6, 7), (2,)]:
        present = tuple(i for i in range(8) if i not in lost)
        surv = shards[sorted(present)[:5]]
        np.testing.assert_array_equal(port.reconstruct(surv, present, lost),
                                      shards[list(lost)])


@pytest.mark.parametrize("d,p", GEOMETRIES)
def test_repair_plan_and_decode_match_reference(d, p):
    port, ref = _pair(d, p)
    n, g = d + p, port.grid
    s = 3
    shards = _shards(ref, 1, s, n)[0]
    shard_size = port.alpha * s
    for f in sorted({0, d - 1, d, n - 1}):
        present = tuple(i for i in range(n) if i != f)
        plan = port.repair_plan(present, (f,), shard_size)
        assert plan == ref.repair_plan(present, (f,), shard_size)
        assert sum(ln for _, _, ln in plan) == (n - 1) * shard_size // g.q
        assert port.repair_fragment_ranges(f, shard_size) == \
            ref.repair_fragment_ranges(f, shard_size)
        planes = g.repair_planes(f)
        c = np.zeros((g.nbar, g.alpha, s), np.uint8)
        for sid in present:
            c[sid, planes] = shards[sid].reshape(g.alpha, s)[planes]
        got = port.repair_decode(c.copy(), f)
        np.testing.assert_array_equal(got, ref.repair_decode(c.copy(), f))
        np.testing.assert_array_equal(got.reshape(-1), shards[f])
    for lost, size in [((0, 1), shard_size), ((0,), shard_size + 1)]:
        present = tuple(i for i in range(n) if i not in lost)
        assert port.repair_plan(present, lost, size) is None
        assert not port.repair_supported(present, lost, size)
    for lost in [(0,), (d,), (0, d)]:
        assert coder_mod.repair_read_bytes("msr", d, p, lost, shard_size) == \
            ref_repair_read_bytes("msr", d, p, lost, shard_size)


@pytest.mark.parametrize("d,p", GEOMETRIES)
def test_interval_plans_and_decodes_match_reference(d, p):
    port, ref = _pair(d, p)
    n = d + p
    s = 40
    shard_size = port.alpha * s
    shards = _shards(ref, 1, s, d + 2 * p)[0]
    spans = [(0, 1), (s - 3, 7), (shard_size // 3 + 11, 2 * s + 2),
             (shard_size - 9, 9)]
    for f, other in [(0, None), (d, None), (n - 1, 1), (1, d)]:
        present = tuple(i for i in range(n) if i not in (f, other))
        for off, ln in spans:
            plan = port.interval_plan(present, f, off, ln, shard_size)
            rplan = ref.interval_plan(present, f, off, ln, shard_size)
            assert (plan.mode, plan.inner, plan.fetch, plan.used) == \
                (rplan.mode, rplan.inner, rplan.fetch, rplan.used)
            assert plan.mode == ("repair" if other is None else "general")
            for a, b in ((plan.planes, rplan.planes), (plan.closure, rplan.closure)):
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a, b)
            fetched = {sid: b"".join(shards[sid][o:o + k].tobytes()
                                     for o, k in plan.byte_ranges(sid))
                       for sid in plan.fetch}
            got = port.interval_decode(plan, fetched)
            assert got == ref.interval_decode(rplan, fetched)
            assert got == shards[f][off:off + ln].tobytes()
            assert plan.bytes_total() == rplan.bytes_total()


def test_apply_runs_k1_entry_and_never_falls_back(monkeypatch):
    """_apply is rs_cuda.gf_apply on the coder's device; a failure there
    raises instead of dropping to numpy."""
    port, ref = _pair(4, 2)
    calls = []
    real = rs_cuda.gf_apply

    def counted(mat, data, *a, **k):
        calls.append((tuple(mat.shape), data.device.type))
        return real(mat, data, *a, **k)
    monkeypatch.setattr(rs_cuda, "gf_apply", counted)
    data = _data((4, port.alpha * 4), 3)
    np.testing.assert_array_equal(port.encode(data), ref.encode(data))
    assert calls and all(dev == "cpu" for _, dev in calls)
    assert all(m * k * 32 <= 48 * 1024 for (m, k), _ in calls)

    def broken(*a, **k):
        raise RuntimeError("kernel library failed to load")
    monkeypatch.setattr(rs_cuda, "gf_apply", broken)
    monkeypatch.setattr(gf8, "np_gf_apply", broken)
    with pytest.raises(RuntimeError, match="failed to load"):
        port.encode(data)


def test_numpy_backend_applies_on_the_host(monkeypatch):
    port, ref = ProductMatrixCoder(4, 2, backend="numpy"), RefPM(4, 2)
    assert port.device is None
    monkeypatch.setattr(rs_cuda, "gf_apply", None)
    data = _data((4, port.alpha * 2), 9)
    np.testing.assert_array_equal(port.encode(data), ref.encode(data))


def test_largest_msr_matrices_fit_k1_tables():
    """The GF matrices _apply hands K1 stay inside its 48 KiB of tables:
    [q, nbar-q] from solve_matrices, [q, <= nbar-1] from repair_matrices."""
    for d, p in [(10, 4), (14, 2)]:
        g = ProductMatrixCoder(d, p, device="cpu").grid
        shapes = [g.repair_matrices(f)[2].shape for f in range(d + p)]
        shapes.append(g.solve_matrices(tuple(range(d)))[2].shape)
        assert max(m * k * 32 for m, k in shapes) <= 48 * 1024
        assert max(m for m, _ in shapes) == p


def test_device_is_the_callers_choice(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ProductMatrixCoder(4, 2, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ProductMatrixCoder(4, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        coder_mod.codec_coder("msr", 4, 2, backend="torch")
