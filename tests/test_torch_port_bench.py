"""The port's bench (``hint_tpu_torch.bench``) on the CPU: its supervisor
with scripted children (the cases of ``tests/test_bench_supervisor.py``),
and the bench itself at batch 64 with ``--device cpu``. Its launch counts
on the card are a card test (``tests/test_torch_port_card.py``)."""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import pytest

from hint_tpu_torch import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# bench.py's keys, and the device the port adds
KEYS = {"metric", "value", "unit", "vs_baseline", "dtype", "impl", "device"}
SMALL = {"HINT_TPU_BENCH_BATCH": "64", "HINT_TPU_BENCH_STEPS": "2", "HINT_TPU_BENCH_REF_STEPS": "1"}

RESULT = '{"metric": "train_steps_per_sec", "value": 1.0, "unit": "steps/s", "vs_baseline": 2.0}'


def _failing(marker_text: str) -> str:
    return f"""
        with open({bench._marker_path()!r}, "w") as f:
            f.write({marker_text!r})
        sys.exit(1)
    """


# each case: the child's body after it counts its run (n = earlier runs),
# the supervisor's exit code, the runs, and the JSON line forwarded
CASES = {
    "success_forwards_one_json_line": (f"print('noise line from warmup')\nprint({RESULT!r})", 0, 1, RESULT),
    "non_json_success_refused": ("print('not json at all')", json.JSONDecodeError, 1, None),
    "retries_unavailable_until_success": (
        "if n < 2:" + textwrap.indent(textwrap.dedent(_failing(
            "RuntimeError: CUDA error: all CUDA-capable devices are busy or unavailable")), "    ")
        + f"print({RESULT!r})", 0, 3, RESULT),
    "nonretryable_fails_at_once": (textwrap.dedent(_failing("ValueError: bogus batch size")), 1, 1, None),
    "gives_up_after_the_attempts": (textwrap.dedent(_failing("unable to initialize backend 'cuda': UNAVAILABLE")),
                                    1, 3, None),
}


@pytest.fixture(autouse=True)
def _fast_retries(monkeypatch):
    monkeypatch.setenv("HINT_TPU_BENCH_ATTEMPTS", "3")
    monkeypatch.setenv("HINT_TPU_BENCH_BACKOFF", "0.05")
    yield
    if os.path.exists(bench._marker_path()):
        os.unlink(bench._marker_path())


@pytest.mark.parametrize("case", list(CASES))
def test_supervisor(tmp_path, capsys, case):
    body, rc, runs, line = CASES[case]
    count = tmp_path / "count"
    child = tmp_path / "child.py"
    child.write_text(
        f"import os, sys\nn = int(open({str(count)!r}).read()) if os.path.exists({str(count)!r}) else 0\n"
        f"open({str(count)!r}, 'w').write(str(n + 1))\n" + body + "\n")
    cmd = [sys.executable, str(child)]
    if isinstance(rc, type):
        with pytest.raises(rc):
            bench._supervise(cmd)
    else:
        assert bench._supervise(cmd) == rc
    assert count.read_text() == str(runs)
    out = capsys.readouterr().out.strip().splitlines()
    assert out == ([line] if line else [])
    assert not os.path.exists(bench._marker_path())


def test_marker_is_not_bench_pys():
    spec = importlib.util.spec_from_file_location("jax_bench", os.path.join(REPO, "bench.py"))
    jax_bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_bench)
    assert bench._marker_path() != jax_bench._marker_path()
    assert os.path.dirname(bench._marker_path()) == os.path.join(REPO, "hint_tpu_torch")
    assert bench._RETRYABLE == jax_bench._RETRYABLE


def _run(args, **env):
    return subprocess.run([sys.executable, "-m", "hint_tpu_torch.bench", *args], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env={**os.environ, **SMALL, **env})


@pytest.mark.parametrize("impl", ["levelwise", "fused"])
def test_bench_prints_one_json_line_on_the_cpu(impl):
    """``--device cpu`` at batch 64: bench.py's keys, finite numbers; the
    fused name takes the plain version on the CPU (no launch)."""
    out = _run(["--device", "cpu"], HINT_TPU_BENCH_IMPL=impl, HINT_TPU_BENCH_DTYPE="float32")
    assert out.returncode == 0, out.stderr
    (line,) = out.stdout.strip().splitlines()
    res = json.loads(line)
    assert set(res) == KEYS
    assert res["metric"] == "train_steps_per_sec" and res["unit"] == "steps/s"
    assert (res["impl"], res["dtype"]) == (impl, "float32")
    assert res["value"] > 0 and res["vs_baseline"] > 0
    assert res["device"] == {"name": "cpu", "power_limit": None}
    (note,) = [ln.split(bench.NOTE, 1)[1] for ln in out.stderr.splitlines() if bench.NOTE in ln]
    note = json.loads(note)
    assert note["baseline_steps_per_sec"] > 0
    assert note == {"steps": 2, "launches": dict.fromkeys(bench.LAUNCH_COUNTS, 0),
                    "baseline_steps_per_sec": note["baseline_steps_per_sec"]}


def test_bench_without_a_card_fails_and_never_falls_back():
    out = _run([], CUDA_VISIBLE_DEVICES="")  # no card, also on a host that has one
    assert out.returncode != 0 and not out.stdout.strip()
    assert "CUDA is not available" in out.stderr and "non-retryable" in out.stderr
    assert not os.path.exists(bench._marker_path())
