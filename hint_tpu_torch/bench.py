"""Training throughput of the port on the flagship (counterpart of ``bench.py``).

    python -m hint_tpu_torch.bench [--device cpu]

Measures training steps/s of ``hint_tpu_torch`` on one CUDA card for
``plus_shape.unconditional_hint_4_full`` (d=100, 4 full-depth HAC blocks,
batch 10,000), by ``bench.py``'s protocol and knobs, and compares it with
the same PyTorch-CPU implementation of the model and step as ``bench.py``
(a copy: the port imports nothing of the JAX package). With no variable
set, ``bench.py`` and this module measure the same thing.

Prints ONE JSON line, ``bench.py``'s keys and the card:
    {"metric": "train_steps_per_sec", "value": N, "unit": "steps/s",
     "vs_baseline": N or null, "dtype": "...", "impl": "...",
     "device": {"name": "...", "power_limit": "..."}}

Env knobs (``bench.py``'s names and defaults):
    HINT_TPU_BENCH_STEPS     timed steps on the card          (default 30)
    HINT_TPU_BENCH_REF_STEPS timed torch-CPU steps; 0: none   (default 3)
    HINT_TPU_BENCH_BATCH     batch size                       (default 10000)
    HINT_TPU_BENCH_IMPL      levelwise | fused                (default levelwise)
    HINT_TPU_BENCH_DTYPE     compute dtype                    (default bfloat16)
    HINT_TPU_BENCH_ATTEMPTS  max tries on a busy card         (default 10)
    HINT_TPU_BENCH_BACKOFF   seconds between tries            (default 60)

The card is required: without one the run fails, unless ``--device cpu``
asks for the CPU. The benchmark runs in a child process; a failure whose
text marks a busy or unavailable device is retried with a fresh process.
On stderr the child notes, as one JSON object after ``NOTE``, the timed
steps, the HAC kernels' launches over them (with ``impl=fused``: 4 forward
and 4 x 2 backward a step) and the baseline's steps/s (null if none).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# substrings (case-insensitive) in a failed child's error that mark the
# failure as transient device trouble worth retrying (bench.py's; CUDA's
# "all CUDA-capable devices are busy or unavailable" matches the first)
_RETRYABLE = (
    "unavailable",
    "unable to initialize backend",
    "backend connection dropped",
    "deadline exceeded",
    "failed to connect",
)

BATCH = int(os.environ.get("HINT_TPU_BENCH_BATCH", 10000))
STEPS = int(os.environ.get("HINT_TPU_BENCH_STEPS", 30))
REF_STEPS = int(os.environ.get("HINT_TPU_BENCH_REF_STEPS", 3))
IMPL = os.environ.get("HINT_TPU_BENCH_IMPL", "levelwise")  # levelwise | fused
DTYPE = os.environ.get("HINT_TPU_BENCH_DTYPE", "bfloat16")
FLAGSHIP = "plus_shape.unconditional_hint_4_full"
WARMUP_STEPS = 3
LR = 1e-3
# the stderr note that carries, as JSON after it, the timed steps, the
# launches over them and the baseline's steps/s; and the counters of
# utils.instrument it reads: the forward kernel (and those of its launches
# made under autograd), the backward kernels (both, and the weight kernel
# among them) and the forward kernel's launches by its bf16 wgmma route and
# by its f32 tiled route
NOTE = "result: "
LAUNCH_COUNTS = {"forward": "hac.launches", "forward_under_autograd": "hac.launches.under_grad",
                 "backward": "hac.bwd_launches", "backward_weights": "hac.bwd_weight_launches",
                 "forward_wgmma": "hac.launches.wgmma", "forward_tiled": "hac.launches.tiled"}
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _note(msg: str) -> None:
    print(f"hint_tpu_torch.bench[child]: {msg}", file=sys.stderr, flush=True)


def card(device) -> dict:
    """The device's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them for a
    card; ``{"name": "cpu", "power_limit": None}`` for the CPU."""
    import torch

    if device.type == "cpu":
        return {"name": "cpu", "power_limit": None}
    index = device.index if device.index is not None else torch.cuda.current_device()
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", str(index)],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name, power_limit = (s.strip() for s in line.rsplit(",", 1))
    return {"name": name, "power_limit": power_limit}


def bench_port(device=None, impl: str = IMPL, compute_dtype: str = DTYPE, batch: int = BATCH,
               steps: int = STEPS):
    """Training steps/s of the port by ``bench.py``'s protocol: the
    flagship trainer under ``impl``/``compute_dtype`` at ``batch``,
    ``init_state(0)``, a fixed x, one device generator for the steps'
    noise, lr 1e-3; 3 warm-up steps, then ``steps`` steps on the host
    clock, each end closed by a synchronise. Returns (steps/s, the HAC
    kernels' launches over the timed steps, by ``LAUNCH_COUNTS``)."""
    import torch

    from hint_tpu_torch.configs import get_config
    from hint_tpu_torch.utils import instrument

    cfg = get_config(FLAGSHIP)
    trainer = cfg.make_trainer(impl=impl, compute_dtype=compute_dtype, device=device)
    trainer.batch_size = batch
    state = trainer.init_state(0)
    dev = trainer.device
    x = torch.randn((batch, cfg.ndim_x), generator=torch.Generator().manual_seed(1)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(2)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    _note(f"warmup on {dev}")
    for _ in range(WARMUP_STEPS):
        terms = trainer.train_step(state, x, None, gen, LR)
    sync()
    _note(f"timing {steps} steps")
    before = instrument.snapshot()
    t0 = time.perf_counter()
    for _ in range(steps):
        terms = trainer.train_step(state, x, None, gen, LR)
    sync()
    dt = time.perf_counter() - t0
    if not bool(torch.isfinite(terms).all()):
        raise FloatingPointError(f"non-finite loss terms after {steps} steps: {terms.tolist()}")
    grown = instrument.since(before)
    launches = {name: grown.get(counter, 0) for name, counter in LAUNCH_COUNTS.items()}
    _note(f"done: {steps / dt:.3f} steps/s")
    return steps / dt, launches


def bench_torch_cpu() -> float:
    """PyTorch-CPU training step on the same model shape (``bench.py``'s,
    copied unchanged in what it computes).

    A from-scratch torch implementation of the flagship architecture (4
    full-depth HAC blocks with Householder perms between blocks), matching
    the reference's per-node sequential execution style and training step
    (noise + NLL + backward + grad clamp + Adam(eps=1e-4)).
    """
    import numpy as np
    import torch
    import torch.nn as nn

    torch.manual_seed(0)
    d = 100
    c_internal = (263, 131, 65, 32, 32)

    def widths(ci):
        ci = tuple(ci)
        if len(ci) == 1:
            ci = ci + ci
        return ci

    class Tree(nn.Module):
        def __init__(self, dim, ci):
            super().__init__()
            ci = widths(ci)
            self.split = dim // 2
            self.out = dim - self.split
            h = ci[0]
            self.s = nn.Sequential(
                nn.Linear(self.split, h), nn.ReLU(), nn.Linear(h, h), nn.ReLU(),
                nn.Linear(h, self.out),
            )
            self.t = nn.Sequential(
                nn.Linear(self.split, h), nn.ReLU(), nn.Linear(h, h), nn.ReLU(),
                nn.Linear(h, self.out),
            )
            self.leaf = dim < 4
            if not self.leaf:
                self.upper = Tree(self.split, ci[1:])
                self.lower = Tree(self.out, ci[1:])

        def forward(self, x):
            xu, xl = x[:, : self.split], x[:, self.split :]
            j = x.new_zeros(x.shape[0])
            if not self.leaf:
                xu, ju = self.upper(xu)
                xl, jl = self.lower(xl)
                j = ju + jl
            s = self.s(xu)
            log_e = 4.0 * 0.636 * torch.atan(s)
            xl = torch.exp(log_e) * xl + self.t(xu)
            return torch.cat([xu, xl], dim=1), j + log_e.sum(dim=1)

    class Model(nn.Module):
        def __init__(self):
            super().__init__()
            self.blocks = nn.ModuleList(Tree(d, c_internal) for _ in range(4))
            qs = []
            for _ in range(3):
                q, _ = np.linalg.qr(np.random.randn(d, d))
                qs.append(torch.tensor(q, dtype=torch.float32))
            self.qs = qs

        def forward(self, x):
            j = x.new_zeros(x.shape[0])
            for i, blk in enumerate(self.blocks):
                if i > 0:
                    x = x @ self.qs[i - 1]
                x, ji = blk(x)
                j = j + ji
            return x, j

    model = Model()
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-4)
    x0 = torch.randn(BATCH, d)

    def step():
        x = x0 + 0.01 * torch.randn_like(x0)
        z, j = model(x)
        loss = (0.5 * z.pow(2).sum(1)).mean() - j.mean()
        opt.zero_grad()
        loss.backward()
        for p in model.parameters():
            if p.grad is not None:
                p.grad.data.clamp_(-5.0, 5.0)
        opt.step()

    step()  # warmup
    t0 = time.perf_counter()
    for _ in range(REF_STEPS):
        step()
    dt = time.perf_counter() - t0
    return REF_STEPS / dt


def _supervise(child_cmd=None, argv=()) -> int:
    """Run the benchmark in child processes, retrying transient device
    failures (``bench.py``'s contract).

    Returns the exit code for the parent process. The child's last stdout
    line is forwarded on success, and only if it parses as JSON; its stderr
    streams through unconditionally so progress stays visible. A failed
    child is retried only where the text it left in the marker file holds
    one of ``_RETRYABLE``. ``child_cmd`` overrides the child argv (tests
    substitute a scripted child); ``argv`` goes to the default child.
    """
    attempts = int(os.environ.get("HINT_TPU_BENCH_ATTEMPTS", 10))
    backoff = float(os.environ.get("HINT_TPU_BENCH_BACKOFF", 60))
    path = os.pathsep.join(p for p in (_REPO, os.environ.get("PYTHONPATH")) if p)
    env = dict(os.environ, HINT_TPU_BENCH_CHILD="1", PYTHONPATH=path)
    for attempt in range(1, attempts + 1):
        print(f"hint_tpu_torch.bench: attempt {attempt}/{attempts}", file=sys.stderr)
        proc = subprocess.run(
            child_cmd or [sys.executable, "-m", "hint_tpu_torch.bench", *argv],
            env=env,
            stdout=subprocess.PIPE,
            text=True,
        )
        if proc.returncode == 0:
            line = proc.stdout.strip().splitlines()[-1]
            json.loads(line)  # refuse to forward a non-JSON result
            print(line)
            return 0
        err_text = ""
        if os.path.exists(_marker_path()):
            with open(_marker_path()) as fh:
                err_text = fh.read()
            os.unlink(_marker_path())
        low = err_text.lower()
        if not any(token in low for token in _RETRYABLE):
            print("hint_tpu_torch.bench: non-retryable failure, giving up", file=sys.stderr)
            return proc.returncode or 1
        if attempt < attempts:
            print(
                f"hint_tpu_torch.bench: device unavailable (attempt {attempt}); retrying in {backoff:.0f}s",
                file=sys.stderr,
            )
            time.sleep(backoff)
    print(f"hint_tpu_torch.bench: giving up after {attempts} attempts", file=sys.stderr)
    return 1


def _marker_path() -> str:
    """Where the child leaves its failure's text for the supervisor: inside
    the package, so that ``bench.py``'s supervisor (``.bench_last_error`` at
    the repo's root) never reads this one's failures, nor this one
    ``bench.py``'s."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), ".bench_last_error")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Training steps/s of hint_tpu_torch on the flagship, on one card")
    ap.add_argument("--device", default=None, help="cpu to run on the CPU (default: CUDA; never a fallback)")
    return ap


def main(argv=None) -> None:
    from hint_tpu_torch.ops.base import resolve_device

    args = _parser().parse_args(argv)
    try:
        device = resolve_device(args.device)
        sps, launches = bench_port(device)
        info = card(device)
    except Exception as e:
        # leave the exception text where the supervisor can classify it
        with open(_marker_path(), "w") as fh:
            fh.write(f"{type(e).__name__}: {e}")
        raise
    ratio = ref_sps = None  # strict-JSON null, never NaN
    if REF_STEPS > 0:
        _note(f"torch-CPU baseline: {REF_STEPS} steps")
        try:
            ref_sps = bench_torch_cpu()
            ratio = round(sps / ref_sps, 2)
        except Exception as e:  # the baseline broken: report the absolute number only
            print(f"torch baseline failed: {e}", file=sys.stderr)
    _note(NOTE + json.dumps({"steps": STEPS, "launches": launches, "baseline_steps_per_sec": ref_sps}))
    print(
        json.dumps(
            {
                "metric": "train_steps_per_sec",
                "value": round(sps, 3),
                "unit": "steps/s",
                "vs_baseline": ratio,
                "dtype": DTYPE,
                "impl": IMPL,
                "device": info,
            },
            allow_nan=False,
        )
    )


if __name__ == "__main__":
    if os.environ.get("HINT_TPU_BENCH_CHILD"):
        main()
    else:
        _parser().parse_args()  # --help and argument errors stop here, not in a child
        sys.exit(_supervise(argv=sys.argv[1:]))
