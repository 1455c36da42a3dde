"""The load generator: a process of its own that posts ``/synthesize``.

Run as ``python client.py`` with one job as JSON on standard input; it
prints one JSON object on standard output and exits. It imports the
standard library alone, so it shares neither the server's interpreter
lock nor its imports.

Job keys: ``host``, ``port``, ``bodies`` (request bodies), ``start``
(``time.monotonic()`` at which the window opens; the clock is the
machine's, the same in every process), ``seconds``, ``mode``:

* ``"closed"``: ``clients`` threads, each posting the next body of a
  shared cycle as soon as its last answer arrived, and none after the
  window;
* ``"open"``: request i is due at ``start + offsets[i]`` with body
  ``i % len(bodies)``; a scheduler thread hands each to one of
  ``connections`` sender threads when it is due.

``keep``: body indices (closed) or request indices (open) whose PCM comes
back (the first answer of each, in the window for closed). ``drain_s``:
how long after the window answers are awaited.

Output: ``records``, one ``[index, body, due, sent, done, status,
samples]`` a request (``status`` is the HTTP status, 0 for an error or
no answer; ``done`` is null without an answer, ``sent`` too when it was
never sent), and ``kept``, ``{index: base64 PCM16}``.
"""

import base64
import http.client
import io
import itertools
import json
import queue
import sys
import threading
import time
import wave


class Poster:
    """One persistent connection."""

    def __init__(self, host: str, port: int, timeout: float):
        self.addr = (host, port)
        self.timeout = timeout
        self.conn = None

    def connect(self) -> None:
        if self.conn is None:
            self.conn = http.client.HTTPConnection(*self.addr,
                                                   timeout=self.timeout)
            self.conn.connect()

    def post(self, body: bytes):
        """(status, pcm bytes); status 0 on a connection error."""
        try:
            self.connect()
            self.conn.request("POST", "/synthesize", body=body,
                              headers={"Content-Type": "application/json"})
            resp = self.conn.getresponse()
            data = resp.read()
        except (OSError, http.client.HTTPException):
            self.close()
            return 0, b""
        if resp.status != 200:
            return resp.status, b""
        with wave.open(io.BytesIO(data), "rb") as w:
            return 200, w.readframes(w.getnframes())

    def close(self):
        if self.conn is not None:
            self.conn.close()
            self.conn = None


def _join(threads, deadline: float) -> None:
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))


def run_closed(job, bodies):
    lock = threading.Lock()
    cycle = itertools.cycle(range(len(bodies)))
    end = job["start"] + job["seconds"]
    keep = set(job.get("keep", ()))
    records, kept = [], {}
    counter = itertools.count()

    def client():
        poster = Poster(job["host"], job["port"], job["drain_s"])
        try:
            while True:
                with lock:
                    now = time.monotonic()
                    if now >= end:
                        return
                    b = next(cycle)
                    i = next(counter)
                    rec = [i, b, now, now, None, None, 0]
                    records.append(rec)
                status, pcm = poster.post(bodies[b])
                done = time.monotonic()
                with lock:
                    rec[4:] = [done, status, len(pcm) // 2]
                    if (status == 200 and b in keep and b not in kept
                            and done <= end):
                        kept[b] = pcm
        finally:
            poster.close()

    pause = job["start"] - time.monotonic()
    if pause > 0:
        time.sleep(pause)
    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(job["clients"])]
    for t in threads:
        t.start()
    _join(threads, end + job["drain_s"])
    return records, kept


def run_open(job, bodies):
    offsets = job["offsets"]
    keep = set(job.get("keep", ()))
    todo: "queue.Queue" = queue.Queue()
    lock = threading.Lock()
    records, kept = [], {}

    def sender():
        poster = Poster(job["host"], job["port"], job["drain_s"])
        try:
            poster.connect()  # before the window
            while True:
                item = todo.get()
                if item is None:
                    return
                i, due = item
                sent = time.monotonic()
                b = i % len(bodies)
                rec = [i, b, due, sent, None, None, 0]
                with lock:
                    records.append(rec)
                status, pcm = poster.post(bodies[b])
                done = time.monotonic()
                with lock:
                    rec[4:] = [done, status, len(pcm) // 2]
                    if status == 200 and i in keep:
                        kept[i] = pcm
        finally:
            poster.close()

    threads = [threading.Thread(target=sender, daemon=True)
               for _ in range(job["connections"])]
    for t in threads:
        t.start()
    for i, off in enumerate(offsets):
        due = job["start"] + off
        pause = due - time.monotonic()
        if pause > 0:
            time.sleep(pause)
        todo.put((i, due))
    for _ in threads:
        todo.put(None)
    _join(threads, job["start"] + job["seconds"] + job["drain_s"])
    with lock:
        seen = {r[0] for r in records}
        for i, off in enumerate(offsets):
            if i not in seen:  # never sent
                due = job["start"] + off
                records.append([i, i % len(bodies), due, None, None, 0, 0])
    return records, kept


def main() -> None:
    job = json.loads(sys.stdin.read())
    bodies = [json.dumps(b).encode() for b in job["bodies"]]
    run = run_closed if job["mode"] == "closed" else run_open
    records, kept = run(job, bodies)
    for rec in records:
        if rec[5] is None:  # sent, and no answer within drain_s
            rec[5] = 0
    out = {"records": sorted(records),
           "kept": {str(k): base64.b64encode(v).decode()
                    for k, v in kept.items()}}
    sys.stdout.write(json.dumps(out))
    sys.stdout.flush()


if __name__ == "__main__":
    main()
