"""The one generator of serving traffic: it reads a mix's parameters
(``traffic/<mix>.json``) and the seed, and gives each closed-loop client
its list of requests.

Parameters of a ``"kind": "serve"`` mix:

* ``clients``: closed-loop clients; each sends its next request when its
  last one has been answered, cycling through its list;
* ``endpoints``: the endpoints a list holds, every size once at each;
* ``sizes``: ``{"log_grid": [lo, hi, k]}`` (k sizes evenly spaced in log,
  both ends included) or ``{"fixed": [n, k]}`` (k requests of n rows);
* ``y_target``: ``"per_client"`` (each client's own condition, a row of
  the data model) or ``"default"`` (the service's default);
* ``check_per_client``: how many of each client's requests in its first
  pass through the list keep their answers for the check: each
  endpoint's largest, then others drawn from the seed.

Every seed gives every client the same sizes at the same endpoints, in an
order of its own, so the seed changes the order and not the work.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from hintbench.lib.work import log_grid


@dataclasses.dataclass
class Request:
    client: int
    index: int
    endpoint: str
    n: int
    seed: int  # the request's own seed: /sample's latents; /log_prob's first row in the pool
    check: bool = False


def sizes(mix: dict) -> List[int]:
    spec = mix["sizes"]
    if "log_grid" in spec:
        return log_grid(*spec["log_grid"])
    n, k = spec["fixed"]
    return [n] * k


def client_requests(mix: dict, seed: int, client: int, pool_rows: int) -> List[Request]:
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0x5E7, client]))
    pairs = [(e, n) for e in mix["endpoints"] for n in sizes(mix)]
    order = rng.permutation(len(pairs))
    reqs = []
    for j, o in enumerate(order):
        e, n = pairs[o]
        s = int(rng.integers(0, pool_rows - n + 1)) if e == "log_prob" else int(rng.integers(0, 2**62))
        reqs.append(Request(client, j, e, n, s))
    check = {max((r for r in reqs if r.endpoint == e), key=lambda r: r.n).index for e in mix["endpoints"]}
    rest = [r.index for r in reqs if r.index not in check]
    extra = max(0, mix["check_per_client"] - len(check))
    check |= set(int(i) for i in rng.choice(rest, size=min(extra, len(rest)), replace=False))
    for r in reqs:
        r.check = r.index in check
    return reqs


def all_requests(mix: dict, seed: int, pool_rows: int) -> List[List[Request]]:
    return [client_requests(mix, seed, c, pool_rows) for c in range(mix["clients"])]


def y_targets(mix: dict, y_rows: Optional[np.ndarray]) -> list:
    """Each client's condition: a row of ``y_rows`` or None (the default)."""
    if mix["y_target"] == "per_client":
        return [y_rows[c].tolist() for c in range(mix["clients"])]
    return [None] * mix["clients"]
