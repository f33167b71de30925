"""The card's idle share over the GET window: 100 x (1 - the servers'
busy time / the window). A server's busy time is the union of its kernel,
copy and memset intervals in its trace; the servers' are summed (one card
without MPS runs one process's work at a time)."""


def read(run):
    if not any(t.device_events for t in run.traces) or not run.window_s:
        return None
    return 100.0 * (1.0 - sum(t.busy_s for t in run.traces) / run.window_s)
