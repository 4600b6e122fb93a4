"""Inference serving: checkpoint-backed sample / log-prob endpoints
(port of ``hint_tpu/serve.py``).

``InferenceService`` pads every request up to a batch bucket, so the device
sees a few fixed shapes (the CUDA kernel takes any batch, but bucketing keeps
the work per call predictable and matches the JAX service), and ``serve()``
exposes it over the same minimal JSON/HTTP API:

    POST /sample   {"n": 100, "y_target": [..]?, "seed": 0?}  -> {"x": [[..]]}
    POST /log_prob {"x": [[..]], "y": [[..]]?}                -> {"log_prob": [..]}
    GET  /health                                              -> {"status": "ok"}

Conditional configs sample ``x | y_target`` (default: the config's
``vis_y_target``) and take ``y`` beside ``x`` for ``/log_prob``; two-lane
(conditional HINT) models answer ``/log_prob`` with the joint density over
``concat(z_x, z_y)`` and sample through ``sample_conditional_hint``.

CLI: ``python -m hint_tpu_torch serve --config ... --ckpt run.npz --port 8000``.
Runs on CUDA unless ``device="cpu"`` is passed.

A request runs under the span ``serve.sample`` or ``serve.log_prob``
(``utils.instrument``, seen while a profiler records), with
``serve.prepare`` (bucket, condition rows, padding) and, for each page,
``serve.lock`` (the wait for the device), ``serve.h2d``, ``serve.compute``
and ``serve.d2h`` in it. Counters: ``serve.requests.sample``,
``serve.requests.log_prob``, ``serve.rows`` (rows asked),
``serve.rows_computed`` (bucket rows over every page) and ``serve.pages``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import threading
from typing import Optional, Sequence, Union

import numpy as np
import torch

from hint_tpu_torch.configs.registry import Config, get_config
from hint_tpu_torch.convert import load_params
from hint_tpu_torch.evaluation.sampling import sample_conditional_hint
from hint_tpu_torch.models.flow import TwoLaneFlow
from hint_tpu_torch.ops.base import exact_f32_matmul, resolve_device
from hint_tpu_torch.train.checkpoint import load_params_npz
from hint_tpu_torch.utils.instrument import count, span

LOG_2PI = math.log(2.0 * math.pi)


class InferenceService:
    def __init__(
        self,
        cfg: Config,
        params,
        buckets: Sequence[int] = (64, 256, 1024, 4096),
        compute_dtype: str = "float32",
        impl: str = "levelwise",
        device=None,
    ):
        """``params``: the JAX package's nested parameter tree (numpy arrays
        or tensors), e.g. from ``train.checkpoint.load_params_npz``."""
        self.device = resolve_device(device)
        if compute_dtype == "float32":
            exact_f32_matmul()
        self.cfg = cfg
        self.model = cfg.build_model(compute_dtype=compute_dtype, impl=impl, device=self.device)
        load_params(self.model, params)
        self.model.eval().requires_grad_(False)
        self.buckets = tuple(sorted(buckets))
        self._two_lane = isinstance(self.model, TwoLaneFlow)
        # the server handles requests on several threads; device work is
        # serialized per call (not per request) so a paged large /sample
        # cannot starve a small /log_prob, and /health takes no lock at all
        self._device_lock = threading.Lock()

    # -- device calls ------------------------------------------------------------

    @contextlib.contextmanager
    def _page(self, rows: int):
        """One device call of ``rows`` bucket rows, under the device lock and
        inference mode."""
        count("serve.pages")
        count("serve.rows_computed", rows)
        with span("serve.lock"):
            self._device_lock.acquire()
        try:
            with torch.inference_mode():
                yield
        finally:
            self._device_lock.release()

    def _sample_fn(self, generator: torch.Generator, y: np.ndarray) -> np.ndarray:
        """One bucket of samples; ``y`` is (bucket, ndim_y), zero columns wide
        for an unconditional model."""
        with self._page(y.shape[0]):
            with span("serve.h2d"):
                yd = torch.from_numpy(y).to(self.device)
            with span("serve.compute"):
                if self._two_lane:
                    x = sample_conditional_hint(self.model, yd, generator)
                else:
                    z = torch.randn((y.shape[0], self.model.dim), generator=generator, device=self.device)
                    x, _ = self.model.inverse(z, yd) if self.cfg.is_conditional else self.model.inverse(z)
            with span("serve.d2h"):
                return x.cpu().numpy()

    def _log_prob_fn(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        with self._page(x.shape[0]):
            with span("serve.h2d"):
                xd, yd = torch.from_numpy(x).to(self.device), torch.from_numpy(y).to(self.device)
            with span("serve.compute"):
                if self._two_lane:
                    z_y, z_x, ld_y, ld_x = self.model.forward(yd, xd)
                    z, ld = torch.cat([z_x, z_y], dim=-1), ld_y + ld_x
                elif self.cfg.is_conditional:
                    z, ld = self.model.forward(xd, yd)
                else:
                    z, ld = self.model.forward(xd)
                d = z.shape[-1]
                lp = -(0.5 * torch.sum(z * z, dim=-1) + 0.5 * d * LOG_2PI) + ld
            with span("serve.d2h"):
                return lp.cpu().numpy()

    # -- helpers -------------------------------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return int(2 ** math.ceil(math.log2(max(n, 1))))

    def _y_for(self, n: int, y_target) -> np.ndarray:
        """``y_target`` (default: the config's ``vis_y_target``) on n rows."""
        dy = self.cfg.ndim_y
        if dy == 0:
            return np.zeros((n, 0), np.float32)
        if y_target is None:
            y_target = self.cfg.vis_y_target
        if y_target is None:
            raise ValueError("conditional model: y_target required")
        y = np.asarray(y_target, np.float32).reshape(-1)
        if y.shape[0] != dy:
            raise ValueError(f"y_target must have {dy} entries")
        return np.broadcast_to(y[None, :], (n, dy)).copy()

    def warmup(self) -> None:
        """Run every bucket once ahead of traffic (builds the kernel and
        packs the weights on first use)."""
        for b in self.buckets:
            self.sample(b, seed=0)
            self.log_prob(np.zeros((b, self.cfg.ndim_x), np.float32))

    # -- endpoints -----------------------------------------------------------------

    def sample(self, n: int, y_target=None, seed: Optional[int] = None) -> np.ndarray:
        """``seed=None`` draws fresh per-request entropy; pass a seed for
        determinism. ``y_target`` is the condition of a conditional model
        (default: the config's ``vis_y_target``); unconditional models
        ignore it.

        Requests larger than the largest bucket page over that bucket, each
        page drawing its latents from the request's one generator."""
        count("serve.requests.sample")
        count("serve.rows", n)
        with span("serve.sample"):
            with span("serve.prepare"):
                if seed is None:
                    seed = int.from_bytes(os.urandom(4), "little")
                generator = torch.Generator(device=self.device).manual_seed(seed)
                b_max = self.buckets[-1]
                pages = 1 if n <= b_max else -(-n // b_max)
                y = self._y_for(self._bucket(n) if pages == 1 else b_max, y_target)
            if pages == 1:
                return self._sample_fn(generator, y)[:n]
            return np.concatenate([self._sample_fn(generator, y) for _ in range(pages)])[:n]

    def log_prob(self, x: np.ndarray, y: Optional[np.ndarray] = None) -> np.ndarray:
        """``y``: one condition row per row of ``x`` (conditional models;
        default: the config's ``vis_y_target`` on every row)."""
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        count("serve.requests.log_prob")
        count("serve.rows", n)
        with span("serve.log_prob"):
            with span("serve.prepare"):
                b = self._bucket(n)
                xp = np.zeros((b, x.shape[1]), np.float32)
                xp[:n] = x
                if y is None:
                    yp = self._y_for(b, None)
                else:
                    y = np.asarray(y, np.float32)
                    if y.shape != (n, self.cfg.ndim_y):
                        raise ValueError(f"y must be ({n}, {self.cfg.ndim_y})")
                    yp = np.zeros((b, y.shape[1]), np.float32)
                    yp[:n] = y
            return self._log_prob_fn(xp, yp)[:n]

    # -- constructors ----------------------------------------------------------------

    @classmethod
    def from_checkpoint(cls, config: Union[str, Config], ckpt_path: str, **kw) -> "InferenceService":
        """Serve the ``params[...]`` entries of an npz written by either
        package (weights-only or a full training state). The model built
        from the config is the template: every key and shape must match."""
        cfg = get_config(config) if isinstance(config, str) else config
        return cls(cfg, load_params_npz(ckpt_path), **kw)


# /sample HTTP cap: the JSON response is O(n * ndim_x) host memory per
# handler thread, so one request must stay bounded. Page client-side for more.
MAX_HTTP_SAMPLE_N = 65_536


def make_server(service: InferenceService, host: str = "127.0.0.1", port: int = 8000):
    """Build (but don't start) the threaded HTTP server over the service."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._reply(200, {"status": "ok", "config": service.cfg.name})
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                if self.path == "/sample":
                    n = int(req.get("n", 1))
                    if n < 1 or n > MAX_HTTP_SAMPLE_N:
                        raise ValueError(f"n out of range [1, {MAX_HTTP_SAMPLE_N}]")
                    seed = req.get("seed")
                    x = service.sample(n, req.get("y_target"), None if seed is None else int(seed))
                    self._reply(200, {"x": x.tolist()})
                elif self.path == "/log_prob":
                    x = np.asarray(req["x"], np.float32)
                    if x.ndim != 2 or x.shape[1] != service.cfg.ndim_x:
                        raise ValueError(f"x must be (n, {service.cfg.ndim_x})")
                    y = req.get("y")
                    lp = service.log_prob(x, None if y is None else np.asarray(y, np.float32))
                    self._reply(200, {"log_prob": lp.tolist()})
                else:
                    self._reply(404, {"error": "unknown path"})
            except Exception as e:  # report, keep serving
                self._reply(400, {"error": str(e)})

        def log_message(self, fmt, *args):  # quiet
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    server.daemon_threads = True  # in-flight handlers don't block shutdown
    return server


def serve(service: InferenceService, host: str = "127.0.0.1", port: int = 8000):
    """Blocking multi-threaded HTTP server; stops cleanly on SIGINT/SIGTERM."""
    import signal

    httpd = make_server(service, host, port)

    def _stop(signum, frame):
        # shutdown() must run off the serve_forever thread
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, _stop)
        except ValueError:  # not the main thread (embedded use)
            pass
    print(f"serving {service.cfg.name} on http://{host}:{httpd.server_port} ({service.device})")
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
    print("server stopped")
