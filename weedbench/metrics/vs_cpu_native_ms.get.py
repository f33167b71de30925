"""Per GET answered, the volume servers' CPU milliseconds in class
`native` of SeaweedFS_process_thread_cpu_seconds_total: the tasks with no
Python thread (gRPC core's pollers and executors, the CUDA driver,
torch's own pools) (weedbench/thread_cpu.py)."""

from weedbench import thread_cpu


def read(run):
    return thread_cpu.per_get_ms(run, "native")
