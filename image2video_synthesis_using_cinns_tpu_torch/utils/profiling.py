"""Tracing and timing (port of ``utils/profiling.py``) on ``torch.profiler``.

- ``trace(logdir)``: a context manager around a ``torch.profiler`` window
  (the host, and the card where there is one); on exit the trace is written
  to ``logdir`` as a Chrome/Perfetto JSON file. It yields the profiler, so
  a caller can read ``key_averages()``.
- ``start_server(port)``: an on-demand capture server for a running job, on
  localhost: ``GET /trace?ms=N`` records the next N ms (default 1000) of the
  process into ``logdir`` and answers with the file's path. Activity on the
  card is traced whole; host ops only on the server's own thread.
- ``annotate(name)``: a ``record_function`` span, so host phases (data wait,
  augment, checkpoint write) show on the trace's timeline.
- ``StepTimer``: wall-clock step times with an EMA, for the trainers' logs;
  ``stop(result)`` first waits for the card when ``result`` holds CUDA
  tensors, where the JAX package blocks until the result is ready.
"""

from __future__ import annotations

import contextlib
import os
import socket
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch
from torch.profiler import ProfilerActivity, profile, record_function


def _activities() -> list:
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])


def _trace_path(logdir: str) -> str:
    os.makedirs(logdir, exist_ok=True)
    return os.path.join(logdir, f"{socket.gethostname()}_{os.getpid()}_"
                                f"{time.time_ns()}.pt.trace.json")


@contextlib.contextmanager
def trace(logdir: str):
    with profile(activities=_activities()) as prof:
        yield prof
    prof.export_chrome_trace(_trace_path(logdir))


def start_server(port: int = 9999, logdir: str = "profiles") -> ThreadingHTTPServer:
    """Serve on-demand traces on ``127.0.0.1:port`` from a daemon thread; the
    server's ``shutdown()`` stops it (``port=0`` picks a free port, which
    ``server_address`` gives)."""

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            url = urllib.parse.urlparse(self.path)
            if url.path != "/trace":
                self.send_error(404)
                return
            ms = float(urllib.parse.parse_qs(url.query).get("ms", ["1000"])[0])
            with profile(activities=_activities()) as prof:
                time.sleep(ms / 1000.0)
            path = _trace_path(logdir)
            prof.export_chrome_trace(path)
            body = path.encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # quiet
            pass

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def annotate(name: str) -> record_function:
    return record_function(name)


def _synchronize(result) -> None:
    """Wait for the cards that hold a tensor of ``result`` (nested lists,
    tuples and dicts)."""
    stack, devices = [result], set()
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    for d in devices:
        torch.cuda.synchronize(d)


class StepTimer:
    def __init__(self, ema: float = 0.9):
        self._ema_coef = ema
        self.ema_ms: float | None = None
        self.last_ms: float = 0.0
        self._t0: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        if result is not None:
            _synchronize(result)
        dt = (time.perf_counter() - self._t0) * 1000.0
        self.last_ms = dt
        self.ema_ms = dt if self.ema_ms is None else (
            self._ema_coef * self.ema_ms + (1 - self._ema_coef) * dt)
        return dt

    @contextlib.contextmanager
    def measure(self):
        self.start()
        try:
            yield self
        finally:
            self.stop()
