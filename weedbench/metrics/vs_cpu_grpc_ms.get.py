"""Per GET answered, the volume servers' CPU milliseconds in class `grpc`
of SeaweedFS_process_thread_cpu_seconds_total: the `grpc-worker` threads
that answer peers' VolumeEcShardRead (weedbench/thread_cpu.py)."""

from weedbench import thread_cpu


def read(run):
    return thread_cpu.per_get_ms(run, "grpc")
