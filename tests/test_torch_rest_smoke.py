"""chip_smoke.py's phase 16 (the rest of the volume server: the Go-format
import, the azure: and gcs-json: tiers against the port's stand-ins, image
needles GET resized from a degraded EC volume, the debug plane after that
traffic — profile summary, flight recorder, traces, events, failpoints,
lifecycle, /ui, hot keys, a device-trace capture, a lock check in a
subprocess under SWTPU_LOCKCHECK=1 — and the hooks' cost) on the CPU at a
small size, its checks as fatal as on the card."""

import numpy as np

import chip_smoke
from seaweedfs_tpu_torch.ec.locate import EcGeometry
from seaweedfs_tpu_torch.images import resize


def test_rest_round_trip_of_chip_smoke_on_cpu(tmp_path):
    res = chip_smoke.rest_round_trip(
        np, str(tmp_path), 41, "cpu",
        EcGeometry(14, 2, large_block=65536, small_block=4096),
        EcGeometry(10, 4, large_block=65536, small_block=4096),
        go_needles=2000, go_deletes=40, go_sample=300, azure_needles=1500,
        gcs_needles=600, tier_gets=64, images=24, jpegs=8,
        image_size=(96, 64), trace_gets=4, hook_gets=128, device="cpu")
    assert res["go"]["walk"] > 0 and res["go"]["reread"] > 0
    assert res["azure"]["cold"] and res["gcs"]["warm"]
    assert res["images"]["pil"] == resize.HAVE_PIL
    assert res["images"]["reconstructs"] > 0
    assert res["locks"]["cycles"] == [] and res["locks"]["enabled"]
    assert len(res["hooks"]["on"]) == len(res["hooks"]["off"]) == 128
