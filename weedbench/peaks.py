"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheet, SXM part, at the full 700 W): bytes a second of device memory."""

HBM_BYTES_PER_S = {"H100": 3.35e12}


def hbm_bytes_per_s(kind: str) -> "float | None":
    for key, rate in HBM_BYTES_PER_S.items():
        if key in kind:
            return rate
    return None
