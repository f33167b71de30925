"""The open-loop GET load: `python -m weedbench.loadgen PLAN OUT`, one
process.

Reads its plan (an .npz the harness wrote), waits for one line on
standard input, "<start> <seconds>" on the monotonic clock every process
of the machine shares, then offers objects at the plan's arrival times
whether or not earlier ones have been answered: a dispatcher thread hands
each arrival to a pool of `workers` threads, the clients, each with
keep-alive connections, so at most `workers` GETs are in flight and
arrivals beyond that wait in the pool's queue. An object is its chunk
needles, read in order, each from the server the plan names (a live
holder picked from the seed where that server is gone). The window ends
`seconds` after the start: no GET starts after it, so the arrivals still
queued then are never sent, and the GETs in flight finish. Writes, per
GET, the needle, when it was due (the object's arrival for its first
chunk, the previous chunk's answer for the next), sent and answered, the
status, the body's length and its BLAKE2b digest. Imports neither torch
nor the program."""

from __future__ import annotations

import hashlib
import http.client
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def main(argv) -> int:
    plan = dict(np.load(argv[0], allow_pickle=False))
    urls = [str(u) for u in plan["urls"]]
    vid, key, cookie = plan["vid"], plan["key"], plan["cookie"]
    objects, server = plan["objects"], plan["server"]
    arrivals = plan["arrivals"]
    line = sys.stdin.readline().split()
    start = float(line[0])
    end = start + float(line[1])
    local = threading.local()
    out: list = []

    def get(srv: int, g: int) -> "tuple[int, bytes]":
        conns = getattr(local, "conns", None)
        if conns is None:
            conns = local.conns = {}
        conn = conns.get(srv)
        if conn is None:
            host, port = urls[srv].rsplit(":", 1)
            conn = conns[srv] = http.client.HTTPConnection(host, int(port),
                                                           timeout=120)
        try:
            conn.request("GET", f"/{vid[g]},{key[g]:x}{cookie[g]:08x}")
            r = conn.getresponse()
            return r.status, r.read()
        except (OSError, http.client.HTTPException):
            conn.close()
            conns.pop(srv, None)
            return -1, b""

    def fetch(i: int) -> None:
        due = start + float(arrivals[i])
        rec = []
        for j, g in enumerate(objects[i]):
            sent = time.monotonic()
            if g < 0 or sent >= end:
                break
            status, body = get(int(server[i, j]), int(g))
            t1 = time.monotonic()
            rec.append((int(g), due, sent, t1, status, len(body),
                        hashlib.blake2b(body, digest_size=16).digest()))
            due = t1
        out.extend(rec)

    with ThreadPoolExecutor(max_workers=int(plan["workers"])) as pool:
        futs = []
        for i in range(len(arrivals)):
            if start + float(arrivals[i]) >= end:
                break
            wait = start + float(arrivals[i]) - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            futs.append(pool.submit(fetch, i))
        for f in futs:
            f.result()
    cols = list(zip(*out)) if out else [[]] * 7
    np.savez(argv[1], g=np.array(cols[0], np.int64),
             due=np.array(cols[1], np.float64),
             sent=np.array(cols[2], np.float64),
             t1=np.array(cols[3], np.float64),
             status=np.array(cols[4], np.int64),
             nbytes=np.array(cols[5], np.int64),
             digest=np.array(cols[6], "S16"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
