"""The readers of the degraded GET's stages inside the volume servers
(the program's SeaweedFS_ec_degraded_read_seconds, _ec_shard_fetch_seconds
and _ec_shard_serve_seconds) on made-up /metrics deltas, and an idle gap
named after the program's own range where it overlaps the gap most."""

import json
import types

import pytest

from weedbench import spec, traces

DEG = "SeaweedFS_ec_degraded_read_seconds"
FETCH = "SeaweedFS_ec_shard_fetch_seconds"
SERVE = "SeaweedFS_ec_shard_serve_seconds"


def _series(name, labels, s, n):
    lab = tuple(sorted(labels.items()))
    return {(f"{name}_sum", lab): s, (f"{name}_count", lab): n,
            (f"{name}_bucket", lab + (("le", "+Inf"),)): n}


def _run(*servers):
    return types.SimpleNamespace(
        scrape_delta={f"r{i + 2}": s for i, s in enumerate(servers)})


def _phases(gather, stage, wait, n):
    out = {}
    for phase, s in (("gather", gather), ("stage", stage), ("wait", wait)):
        out.update(_series(DEG, {"phase": phase}, s, n))
    return out


@pytest.mark.parametrize("name, ms", [("ec_gather_ms.get", 500.0),
                                      ("k1_stage_ms.get", 40.0),
                                      ("k1_wait_ms.get", 2.0)])
def test_phase_readers_average_over_every_server(name, ms):
    # r2: 10 intervals, gather 3 s, stage 0.3 s, wait 0.01 s;
    # r3: 30 intervals, gather 17 s, stage 1.3 s, wait 0.07 s
    run = _run(_phases(3.0, 0.3, 0.01, 10), _phases(17.0, 1.3, 0.07, 30))
    assert spec.reader(name).read(run) == pytest.approx(ms)


def test_fetch_and_serve_readers():
    r2 = {**_series(FETCH, {}, 12.0, 240),
          **_series(SERVE, {"kind": "range"}, 2.0, 200),
          **_series(SERVE, {"kind": "fragment"}, 50.0, 1)}
    r3 = {**_series(FETCH, {}, 6.0, 120),
          **_series(SERVE, {"kind": "range"}, 1.6, 160)}
    run = _run(r2, r3)
    assert spec.reader("ec_fetch_ms.get").read(run) == pytest.approx(50.0)
    # the fragment answers are not ranges
    assert spec.reader("ec_serve_ms.get").read(run) == pytest.approx(10.0)


@pytest.mark.parametrize("name", ["ec_gather_ms.get", "ec_fetch_ms.get",
                                  "ec_serve_ms.get", "k1_stage_ms.get",
                                  "k1_wait_ms.get"])
def test_readers_read_nothing_where_nothing_was_counted(name):
    # a program without the families (the parent of this change), and one
    # whose families did not move in the window
    assert spec.reader(name).read(_run({}, {})) is None
    still = {**_phases(0.0, 0.0, 0.0, 0), **_series(FETCH, {}, 0.0, 0),
             **_series(SERVE, {"kind": "range"}, 0.0, 0)}
    assert spec.reader(name).read(_run(still)) is None


def test_an_idle_gap_is_named_after_the_programs_range(tmp_path):
    """A user_annotation `ec.gather` and a shorter cuda_runtime
    cudaMemcpyAsync both overlap the window's one idle gap: the gap is
    named after the range."""
    ev = [{"ph": "X", "cat": "kernel", "name": n, "ts": ts, "dur": 1}
          for n, ts in [("fill", 0)] + [("add", 10 + i) for i in range(4)]]
    ev += [{"ph": "X", "cat": "kernel", "name": "rs_gf_apply_kernel",
            "ts": 1_000_014, "dur": 100},
           {"ph": "X", "cat": "user_annotation", "name": "ec.gather",
            "ts": 1_000_200, "dur": 900_000},
           {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
            "ts": 1_500_000, "dur": 300_000},
           {"ph": "X", "cat": "kernel", "name": "rs_gf_apply_kernel",
            "ts": 3_000_000, "dur": 14}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    t = traces.read(str(path), "r2", 4, window=(100.0, 101.0, 103.0))
    assert t.gaps[0] == ("r2: ec.gather",
                         pytest.approx((3_000_000 - 1_000_114) / 1e6))
