"""The 95th percentile, in milliseconds, of every GET sent in the window,
from when it was sent to its answer, as the load's clients timed it: the
time a GET takes with the cell's clients all in flight. A failed or wrong
GET counts as above any limit. Over capacity the queue in front of the
clients grows all through the window, so the time from a GET's arrival
says nothing steady and is not read."""

import numpy as np

FAILED_MS = 1e9


def read(run):
    g, ok = run.data.get("gets"), run.data.get("ok")
    if g is None or not len(g["sent"]):
        return None
    lat = np.where(ok, (g["t1"] - g["sent"]) * 1e3, FAILED_MS)
    return float(np.percentile(lat, 95))
