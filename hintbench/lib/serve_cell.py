"""A serving cell: the program's ``InferenceService`` in-process, driven by
the closed-loop clients of a traffic mix (``lib/traffic.py``) from one
thread, as one server takes requests in the order they arrive.

Set-up builds the service from the benchmark's weights (handed over as a
checkpoint's parameter tree), makes the pool of data rows that
``/log_prob`` requests read and the clients' conditions, and warms every
shape the traffic sends (the service's buckets, its paging) at each
endpoint by one pass of the first client's list, which holds them all.
The window starts every client at once; a client sends requests until
``--seconds`` have passed, and the window closes when the last answer is
in. Each request's latency runs from the moment its client sent it to its
answer.

One thread and not one a client: with 8 client threads in one process the
interpreter's lock made the rate swing by a third from run to run and cost
a fifth of it (PERF.md).
"""

from __future__ import annotations

import collections
import math
import time

import numpy as np
import torch

from hintbench.lib import traffic as T
from hintbench.lib import weights as W
from hintbench.lib.plusdata import plus_rows

POOL_ROWS = 65536
BUCKETS = (64, 256, 1024, 4096)  # the service's default buckets
LOG_2PI = math.log(2.0 * math.pi)


def bucket(n: int) -> int:
    for b in BUCKETS:
        if n <= b:
            return b
    return int(2 ** math.ceil(math.log2(max(n, 1))))


class ServeCell:
    def __init__(self, cfg: dict, traffic: dict, config_module, seed: int, device, strict: bool = True):
        self.cfg, self.mix, self.seed, self.device = cfg, traffic, seed, torch.device(device)
        self.flow = config_module.reference(cfg)
        self.work = config_module.work(cfg, False)
        self.strict = strict

    # -- set-up --------------------------------------------------------------------------

    def setup(self) -> None:
        from hintbench.lib import program
        from hint_tpu_torch.serve import InferenceService

        cfg = self.cfg
        pcfg = program.config(cfg, self.strict)
        self.weights = W.make(self.flow, self.seed, self.device, "serve")
        tree = {}
        for k, v in self.weights.items():
            *path, leaf = k.split(".")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v.cpu().numpy()
        self.svc = InferenceService(pcfg, tree, buckets=BUCKETS, compute_dtype=cfg["compute_dtype"],
                                    impl=cfg["impl"], device=self.device)
        x, y = plus_rows(POOL_ROWS, self.seed, self.device)
        self.pool_x = x.cpu().numpy()
        self.pool_y = y.cpu().numpy() if cfg["ndim_y"] else None
        self.requests = T.all_requests(self.mix, self.seed, POOL_ROWS)
        self.targets = T.y_targets(self.mix, self.pool_y)
        # the first client's list holds every size at every endpoint: one pass
        # of it warms every shape the window sends, and the host's allocator
        for r in self.requests[0]:
            self._call(r)
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _call(self, r: T.Request):
        if r.endpoint == "sample":
            return self.svc.sample(r.n, self.targets[r.client], seed=r.seed)
        x = self.pool_x[r.seed: r.seed + r.n]
        y = None if self.pool_y is None else self.pool_y[r.seed: r.seed + r.n]
        return self.svc.log_prob(x, y)

    # -- the window ------------------------------------------------------------------------

    def window(self, seconds: float) -> dict:
        """The clients' closed loop, served in the order the requests arrive
        by one thread: a client sends its next request when its last one is
        answered, and waits behind the requests sent before it, so each
        latency holds the queue's wait and the request's own time."""
        answers, records, errors = {}, [], []
        nxt = [0] * len(self.requests)
        t0 = time.perf_counter()
        queue = collections.deque((c, t0) for c in range(len(self.requests)))
        while queue:
            c, sent = queue.popleft()
            if sent - t0 >= seconds:  # this client's next request would start after the window: it stops
                continue
            reqs = self.requests[c]
            r = reqs[nxt[c] % len(reqs)]
            try:
                ans = self._call(r)
                ok = ans.shape[0] == r.n
            except Exception as exc:  # noqa: BLE001 - a failed request is counted, and the run goes on
                ans, ok = None, False
                errors.append(repr(exc))
            done = time.perf_counter()
            records.append((sent, done, r.n, ok))
            if ok and r.check and nxt[c] < len(reqs):
                answers[(c, r.index)] = ans
            nxt[c] += 1
            queue.append((c, done))
        self.answers = answers
        close = max(done for _, done, _, _ in records)
        # a failed request counts as missing any limit: it waited the whole window
        lat = sorted((e - s if ok else close - t0) * 1e3 for s, e, _, ok in records)
        return {"attempted": len(records), "failed": sum(not ok for *_, ok in records),
                "rows": sum(n for _, _, n, ok in records if ok), "seconds": close - t0,
                "latencies_ms": lat, "errors": errors[:5]}

    def release(self) -> None:
        del self.svc
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the plain reference ------------------------------------------------------------------

    def _inputs(self, r: T.Request):
        """A request's rows as the service saw them: the latents it draws
        for the request (its bucket's, or a page's at a time, from the
        request's seed) or its pool rows; and the condition of each row."""
        d = self.cfg["ndim_x"]
        if r.endpoint == "sample":
            g = torch.Generator(device=self.device).manual_seed(r.seed)
            if r.n <= BUCKETS[-1]:
                inp = torch.randn((bucket(r.n), d), generator=g, device=self.device)[: r.n]
            else:
                pages = -(-r.n // BUCKETS[-1])
                inp = torch.cat([torch.randn((BUCKETS[-1], d), generator=g, device=self.device)
                                 for _ in range(pages)])[: r.n]
        else:
            inp = torch.from_numpy(self.pool_x[r.seed: r.seed + r.n]).to(self.device)
        cond = None
        if self.cfg["ndim_y"]:
            if r.endpoint == "sample":
                y = self.targets[r.client] if self.targets[r.client] is not None else self.cfg["vis_y_target"]
                cond = torch.tensor(y, dtype=torch.float32, device=self.device).expand(r.n, -1)
            else:
                cond = torch.from_numpy(self.pool_y[r.seed: r.seed + r.n]).to(self.device)
        return inp, cond

    @torch.no_grad()
    def expected(self, reqs, mode: str = "float32", rows: int = 65536) -> list:
        """The reference's answers to requests of one endpoint, computed
        over all their rows together in blocks of ``rows``: the inverse of
        the latents, or the log-density of the rows."""
        if not reqs:
            return []
        dt = torch.float64 if mode == "float64" else torch.float32
        p = {k: v.to(dt) for k, v in self.weights.items()}
        d = self.cfg["ndim_x"]
        pairs = [self._inputs(r) for r in reqs]
        inp = torch.cat([a for a, _ in pairs])
        cond = None if pairs[0][1] is None else torch.cat([c for _, c in pairs])
        outs = []
        for i in range(0, inp.shape[0], rows):
            a = inp[i: i + rows].to(dt)
            c = None if cond is None else cond[i: i + rows].to(dt)
            if reqs[0].endpoint == "sample":
                outs.append(self.flow.inverse(p, a, c, mode)[0])
            else:
                z, ld = self.flow.forward(p, a, c, mode)
                outs.append(-(0.5 * (z * z).sum(dim=1) + 0.5 * d * LOG_2PI) + ld)
        return list(torch.cat(outs).split([r.n for r in reqs]))

    def checked(self) -> dict:
        """The requests whose answers the window kept, by endpoint, with the
        answers."""
        out = {}
        for (c, i), ans in sorted(self.answers.items()):
            r = self.requests[c][i]
            out.setdefault(r.endpoint, []).append((r, ans))
        return out

    def numbers(self, mode: str = "float32", answers: dict = None) -> dict:
        """The widest gap of the kept answers (or of ``answers``, by
        endpoint, as ``checked()`` gives them) against the reference's."""
        from hintbench.lib.check import widest

        got = self.checked() if answers is None else answers
        names = {"sample": "sample_gap", "log_prob": "logprob_gap"}
        out = {}
        for e in self.mix["endpoints"]:
            pairs = got.get(e, [])
            refs = self.expected([r for r, _ in pairs], mode)
            gaps = [widest(torch.as_tensor(a).to(self.device), ref) for (_, a), ref in zip(pairs, refs)]
            out[names[e]] = max(gaps) if gaps else math.inf
        return out
