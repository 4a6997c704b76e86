"""The two load loops, each driven from the main thread.

Open loop: requests are submitted at their due times whatever the system
is doing; each request's ``arrival`` is its due time, so a stall anywhere
(the generator, admission, a lane) counts in every later request's
latency. How late the generator ran is kept per request.

Closed loop: ``clients`` callers each keep one request outstanding and
send the next when the last returns, until the window closes.

After the window each loop waits for what is outstanding (a minute at
most): a late answer is late, one that never comes has failed.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import queue
import time

import numpy as np

WAIT_AFTER_S = 60.0


@dataclasses.dataclass
class Sent:
    """One submitted request: its ``Request``, future, and whether the
    check samples it."""

    request: object
    future: object
    checked: bool
    late_s: float = 0.0


@dataclasses.dataclass
class LoopResult:
    sent: list
    t0: float           # window start (monotonic)
    t_end: float        # window end (monotonic)
    failed: int         # raised, or no answer a minute after the close
    metrics: object     # the engine's ServeMetrics of the window


def _wait(engine, sent: list, t_end: float) -> int:
    """Wait for every outstanding answer until a minute past the close;
    return how many failed."""
    futs = [s.future for s in sent if s.future is not None]
    _, pending = cf.wait(futs, timeout=max(t_end + WAIT_AFTER_S
                                           - time.monotonic(), 0.0))
    if not pending:
        try:
            engine.drain()      # every completion's accounting has run
        except Exception:       # counted per future below
            pass
    failed = sum(s.future is None for s in sent)
    for s in sent:
        f = s.future
        if f is None:
            continue
        if f in pending or f.exception() is not None \
                or s.request.done is None:
            failed += 1
    return failed


def open_loop(engine, schedule, seconds: float, capture,
              request_cls) -> LoopResult:
    """Submit every request of ``schedule`` at its due time."""
    checked = set(schedule.checked)
    sent = []
    metrics = engine.begin_run()
    t0 = time.monotonic() + 0.01
    for i, (off, seeds) in enumerate(zip(schedule.due, schedule.seeds)):
        due = t0 + float(off)
        delay = due - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        req = request_cls(i, seeds, due)
        if i in checked:
            capture.want(seeds)
        late = time.monotonic() - due
        try:
            fut = engine.submit_batch([req])
        except Exception:
            fut = None
        sent.append(Sent(req, fut, i in checked, late))
    t_end = t0 + seconds
    failed = _wait(engine, sent, t_end)
    return LoopResult(sent=sent, t0=t0, t_end=t_end, failed=failed,
                      metrics=engine.end_run(metrics))


def closed_loop(engine, requests, clients: int, seconds: float, capture,
                request_cls) -> LoopResult:
    """``clients`` callers, each with one request outstanding, for
    ``seconds``."""
    checked = set(requests.checked)
    done_q: queue.Queue = queue.Queue()
    sent = []
    metrics = engine.begin_run()
    t0 = time.monotonic()
    t_end = t0 + seconds

    def submit(client: int) -> None:
        i = len(sent)
        seeds = requests.next()
        if i in checked:
            capture.want(seeds)
        req = request_cls(i, seeds, time.monotonic())
        try:
            fut = engine.submit_batch([req])
        except Exception:
            sent.append(Sent(req, None, i in checked))
            return
        sent.append(Sent(req, fut, i in checked))
        fut.add_done_callback(lambda _f, c=client: done_q.put(c))

    for c in range(clients):
        submit(c)
    while True:
        left = t_end - time.monotonic()
        if left <= 0:
            break
        try:
            client = done_q.get(timeout=left)
        except queue.Empty:
            break
        if time.monotonic() < t_end:
            submit(client)
    failed = _wait(engine, sent, t_end)
    return LoopResult(sent=sent, t0=t0, t_end=t_end, failed=failed,
                      metrics=engine.end_run(metrics))


def lateness_ms(res: LoopResult) -> np.ndarray:
    """How late the generator submitted each request."""
    return np.asarray([s.late_s * 1e3 for s in res.sent] or [0.0])


def latencies_ms(res: LoopResult) -> np.ndarray:
    """Each request's latency from its due time, ``inf`` where it
    failed."""
    out = []
    for s in res.sent:
        r = s.request
        ok = (s.future is not None and s.future.done()
              and s.future.exception() is None and r.done is not None)
        out.append((r.done - r.arrival) * 1e3 if ok else np.inf)
    return np.asarray(out, dtype=np.float64)


def seeds_completed(res: LoopResult) -> int:
    """Seeds of the requests that completed inside the window."""
    return int(sum(s.request.seeds.shape[0] for s in res.sent
                   if s.request.done is not None
                   and s.request.done <= res.t_end
                   and s.future is not None and s.future.done()
                   and s.future.exception() is None))
