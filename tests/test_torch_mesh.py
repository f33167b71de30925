"""The port's multi-device EC step against the JAX package's.

Gloo worlds of 4 CPU ranks (parallel/launch.py) run the port's sharded
encode, rebuild and scrub, ECPipeline.step and a MeshCoder-fed
encode_volumes (tests/torch_mesh_ranks.py, which imports no JAX) on 2x2 and
1x4 meshes; the JAX package runs its shard_map versions on
build_mesh(4, shard_axis=2) and build_mesh(4) over the virtual CPU devices
of tests/conftest.py, on the same numpy inputs. Results must be byte-equal,
and equal on every rank. Each world is bounded by its own timeout.

Run alone: JAX_PLATFORMS=cpu python -m pytest tests/test_torch_mesh.py -q
"""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_mesh_ranks
from seaweedfs_tpu.ec import stream as ref_stream
from seaweedfs_tpu.ec.locate import EcGeometry as RefGeo
from seaweedfs_tpu.models.ec_pipeline import ECPipeline as RefPipeline
from seaweedfs_tpu.ops.coder import NumpyCoder as RefNumpyCoder
from seaweedfs_tpu.parallel import pipeline as ref_pp
from seaweedfs_tpu.parallel.mesh import build_mesh as ref_build_mesh
from seaweedfs_tpu_torch.models.ec_pipeline import ECPipeline
from seaweedfs_tpu_torch.ops import coder as coder_mod
from seaweedfs_tpu_torch.parallel import launch, mesh as port_mesh
from seaweedfs_tpu_torch.parallel import pipeline as pp

MESHES = {"2x2": 2, "1x4": None}  # mesh -> shard_axis of build_mesh(4, .)
GEOMETRIES = torch_mesh_ranks.GEOMETRIES
LOSSES = torch_mesh_ranks.LOSSES
LARGE, SMALL = torch_mesh_ranks.LARGE, torch_mesh_ranks.SMALL
WORLD_TIMEOUT = 240.0


def _ceil_to(x, m):
    return (x + m - 1) // m * m


@pytest.fixture(scope="module", params=list(MESHES))
def world(request, tmp_path_factory):
    """(port results per rank, cases, reference mesh, workdir) of one mesh
    shape: one launched world of 4 gloo ranks runs every check."""
    shard_axis = MESHES[request.param]
    ref_mesh = ref_build_mesh(4, shard_axis=shard_axis)
    tmp = tmp_path_factory.mktemp(f"mesh{request.param}")
    cases = torch_mesh_ranks.make_cases(ref_mesh.shape["shard"],
                                        ref_mesh.shape["data"], tmp)
    results = launch.launch(torch_mesh_ranks.sharded_results, 4,
                            args=(4, shard_axis, cases, str(tmp), "cpu"),
                            device="cpu", timeout=WORLD_TIMEOUT)
    return results, cases, ref_mesh, tmp


class _RefMeshCoder(ref_pp.MeshCoder):
    """The reference MeshCoder with the `codec` attribute its
    ec/stream.encode_volumes reads (ErasureCoder's, which MeshCoder does
    not subclass)."""
    codec = "rs"


def _put(mesh, arr, *spec):
    return jax.device_put(arr, NamedSharding(mesh, P(*spec)))


def test_mesh_layout_matches_reference(world):
    results, _, ref_mesh, _ = world
    n_shard = ref_mesh.shape["shard"]
    ids = np.vectorize(lambda dv: dv.id)(ref_mesh.devices)
    for r, res in enumerate(results):
        assert res["rank"] == r and res["mesh"] == dict(ref_mesh.shape)
        # rank r sits where np.reshape puts device r (row-major)
        assert res["coords"] == divmod(r, n_shard)
        assert ids[res["coords"]] == ids.ravel()[r]


def test_every_rank_holds_the_global_result(world):
    results = world[0]
    for res in results[1:]:
        for geo in GEOMETRIES:
            a, b = results[0][geo], res[geo]
            np.testing.assert_array_equal(a["parity"], b["parity"])
            for lost in LOSSES[geo]:
                np.testing.assert_array_equal(a["rebuilt"][lost],
                                              b["rebuilt"][lost])
            assert a["shards"] == b["shards"] and a["step"] == b["step"]
            np.testing.assert_array_equal(a["encode_odd"], b["encode_odd"])
        assert res["scrub_damaged"] == results[0]["scrub_damaged"]


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_encode_sharded_matches_jax(world, geo):
    results, cases, ref_mesh, _ = world
    d, p = geo
    data = cases["geometries"][geo]["data"]
    want = np.asarray(ref_pp.encode_sharded(
        ref_mesh, _put(ref_mesh, data, "data", None, None), d, p))
    p_pad = _ceil_to(p, ref_mesh.shape["shard"])
    assert want.shape == (4, p_pad, 128)
    for res in results:
        np.testing.assert_array_equal(res[geo]["parity"], want)
        assert res[geo]["parity_local_shape"] == (
            4 // ref_mesh.shape["data"], p_pad // ref_mesh.shape["shard"], 128)
    # padding rows are zero; the real rows are RS parity
    np.testing.assert_array_equal(want[:, :p],
                                  np.asarray(RefNumpyCoder(d, p).encode(data)))
    assert not want[:, p:].any()


@pytest.mark.parametrize("geo,k", [(g, k) for g in GEOMETRIES for k in range(3)])
def test_rebuild_sharded_matches_jax(world, geo, k):
    results, cases, ref_mesh, _ = world
    d, p = geo
    lost = LOSSES[geo][k]
    case = cases["geometries"][geo]
    present = tuple(i for i in range(d + p) if i not in lost)
    want = np.asarray(ref_pp.rebuild_sharded(
        ref_mesh, _put(ref_mesh, case["wiped"][lost], "data", "shard", None),
        present, d, p))
    np.testing.assert_array_equal(want[:, :d + p], case["shards"][:, :d + p])
    for res in results:
        np.testing.assert_array_equal(res[geo]["rebuilt"][lost], want)


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_step_matches_jax(world, geo):
    results, cases, ref_mesh, _ = world
    d, p = geo
    case = cases["geometries"][geo]
    pipe = RefPipeline(d=d, p=p, mesh=ref_mesh)
    out = jax.jit(pipe.step, static_argnums=(1,))(
        _put(ref_mesh, case["step_data"], "data", None, None), case["step_lost"])
    want = {k: int(np.asarray(v)) for k, v in out.items()}
    assert want["rebuild_mismatch_bytes"] == 0
    for res in results:
        assert res[geo]["step"] == want
        assert res[geo]["step_n_pad"] == pipe.n_pad()


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_mesh_coder_stream_matches_jax(world, geo):
    results, cases, ref_mesh, tmp = world
    d, p = geo
    ref_geo = RefGeo(d=d, p=p, large_block=LARGE, small_block=SMALL)
    jobs = [(dat, str(tmp / f"ref_{d}_{p}_{i}"), None)
            for i, dat in enumerate(cases["dats"])]
    ref_stream.encode_volumes(jobs, ref_geo, _RefMeshCoder(ref_mesh, d, p),
                              batch=cases["batch"])
    want = [[open(f"{b}.ec{s:02d}", "rb").read() for s in range(d + p)]
            for _, b, _ in jobs]
    for res in results:
        assert res[geo]["stream_mode"] == "async"
        assert res[geo]["shards"] == want


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_mesh_coder_pads_the_batch(world, geo):
    """A batch of 3 stripes over a data axis of 2 is padded and cut back,
    in encode (against the reference MeshCoder) and reconstruct (against
    the oracle: the reference's reconstruct does not pad)."""
    results, cases, ref_mesh, _ = world
    d, p = geo
    case = cases["geometries"][geo]
    want = np.asarray(ref_pp.MeshCoder(ref_mesh, d, p).encode(case["odd"]))
    for res in results:
        np.testing.assert_array_equal(res[geo]["encode_odd"], want)
        np.testing.assert_array_equal(res[geo]["reconstruct"],
                                      case["full"][:, list(case["wanted"])])


def test_scrub_sharded_matches_jax(world):
    results, cases, ref_mesh, _ = world
    sc = cases["scrub"]
    spec = (("data", "shard"),)
    states = _put(ref_mesh, sc["states"].astype(np.uint32), *spec)
    clean = int(np.asarray(ref_pp.scrub_sharded(
        ref_mesh, _put(ref_mesh, sc["blocks"], ("data", "shard"), None), states)))
    bad = int(np.asarray(ref_pp.scrub_sharded(
        ref_mesh, _put(ref_mesh, sc["damaged"], ("data", "shard"), None), states)))
    assert (clean, bad) == (0, 3)
    want = RefPipeline(mesh=ref_mesh).scrub(sc["rotted"], sc["lengths"])
    assert want == 3
    for res in results:
        assert (res["scrub_blocks"], res["scrub_damaged"],
                res["pipeline_scrub"]) == (clean, bad, want)


def test_failing_rank_fails_the_launch_in_bounded_time():
    """A rank that raises fails the launch at once; the ranks left waiting
    in a collective are killed, not waited for."""
    import time
    t0 = time.monotonic()
    with pytest.raises(launch.LaunchError, match="fails on purpose"):
        launch.launch(torch_mesh_ranks.fail_on_rank, 2, args=(1,),
                      device="cpu", timeout=WORLD_TIMEOUT)
    assert time.monotonic() - t0 < WORLD_TIMEOUT / 2
    with pytest.raises(ValueError, match="at least one rank"):
        launch.launch(torch_mesh_ranks.fail_on_rank, 0, device="cpu")


def test_mesh_and_native_coders_resolve_in_process():
    """get_coder("mesh", device="cpu") makes a world of one over gloo in
    this process (destroyed again here); get_coder("native") builds the
    port's C++ library. Both are byte-equal to the oracle."""
    assert not dist.is_initialized()
    data = np.random.default_rng(5).integers(0, 256, (3, 10, 100), np.uint8)
    want = np.asarray(RefNumpyCoder(10, 4).encode(data))
    mesh_coder = coder_mod.get_coder("mesh", 10, 4, device="cpu")
    try:
        assert isinstance(mesh_coder, pp.MeshCoder)
        assert mesh_coder.mesh.shape == {"data": 1, "shard": 1}
        assert str(dist.get_backend()) == "gloo"
        np.testing.assert_array_equal(mesh_coder.encode(data), want)
        np.testing.assert_array_equal(mesh_coder.encode(data[0]), want[0])
        # a second mesh uses the world that exists and does not own it
        pipe = ECPipeline(d=10, p=4, device="cpu")
        assert pipe.n_pad() == 14 and pipe.mesh.shape == {"data": 1, "shard": 1}
        pipe.close()
        assert dist.is_initialized()
    finally:
        mesh_coder.mesh.close()
    assert not dist.is_initialized()
    native = coder_mod.get_coder("native", 10, 4)
    np.testing.assert_array_equal(native.encode(data), want)
    assert not getattr(coder_mod, "_NOT_PORTED", ())


def test_build_mesh_refuses_what_it_cannot_give(monkeypatch):
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="requested 4 devices, only 1"):
        port_mesh.build_mesh(4, device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        port_mesh.build_mesh(1, shard_axis=3, device="cpu")
    assert not dist.is_initialized()  # the failed build released its world
    assert [port_mesh.default_shard_axis(n) for n in (1, 2, 3, 4, 6, 8)] == \
        [1, 2, 1, 4, 2, 4]
    assert dict(ref_build_mesh(8).shape) == {"data": 2, "shard": 4}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: port_mesh.build_mesh(),
                 lambda: coder_mod.get_coder("mesh", 10, 4),
                 lambda: launch.launch(torch_mesh_ranks.fail_on_rank, 1)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert not dist.is_initialized()
