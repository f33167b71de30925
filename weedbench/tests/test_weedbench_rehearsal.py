"""Whole runs of each cell rehearsed on the CPU (`-device cpu` servers, the
data cut by --scale): the last line's keys, its checks, and `correct`
coming out false with the timed path broken underneath."""

import pytest

from ._runs import KEYS, run_cell

SMALL = {"rs14_2.get_diskloss_chunks": ["--scale", "0.07"]}


@pytest.mark.slow
@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("trace", [0, 1])
def test_a_sound_run_is_correct(cell, trace):
    res, err = run_cell(cell, 2**31 + 11, "--rehearse", *SMALL[cell],
                        "--trace", str(trace))
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert res["device"]["platform"] == "cpu"
    if trace:
        assert set(res["device"]) >= {"busy_s", "window_s"}
        assert "breakdown" in res and "setup_s" not in res["metrics"]
    else:
        assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2
    # the checks are the last lines on standard error
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert [ln.split(":")[0] for ln in tail] == [
        f"check {k}" for k in res["checks"]]


@pytest.mark.slow
@pytest.mark.parametrize("cell,fault", [
    ("rs14_2.get_diskloss_chunks", "answer_byte"),
    ("rs14_2.get_diskloss_chunks", "wire_corrupt"),
])
def test_a_broken_program_is_not_correct(cell, fault):
    res, _ = run_cell(cell, 2**32 + 5, "--rehearse", *SMALL[cell],
                      "--fault", fault)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
