"""Per GET answered, the volume servers' CPU milliseconds in some thread
classes of SeaweedFS_process_thread_cpu_seconds_total{class} (each
server's threads' user + system time, read from /proc when /metrics is
scraped), from the deltas of every live server's /metrics across the
window, over the Δcount of SeaweedFS_volumeServer_stage_seconds{type="get",
stage="store"}: the GETs the servers answered, as `vs_store_ms.get`
counts them. Nothing (no line) where the family did not move."""

from weedbench import promstat

CPU = "SeaweedFS_process_thread_cpu_seconds_total"
STAGE = "SeaweedFS_volumeServer_stage_seconds_count"


def per_get_ms(run, *classes: str) -> "float | None":
    moved = cpu = gets = 0.0
    for series in run.scrape_delta.values():
        moved += promstat.total(series, CPU)
        cpu += sum(promstat.total(series, CPU, **{"class": c})
                   for c in classes)
        gets += promstat.total(series, STAGE, type="get", stage="store")
    return cpu / gets * 1e3 if moved and gets else None
