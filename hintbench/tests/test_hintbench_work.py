"""The work counts against PERF.md's 967,756 operations a row for a
flagship block-pass, and the metric readers on a made-up trace."""

import json

from hintbench.lib.peaks import H100
from hintbench.lib.spec import ROOT, load_module
from hintbench.lib.work import hac_params, hac_row_flops

FLAGSHIP = "plus_shape.unconditional_hint_4_full"


def _flow(name):
    cfg = json.loads((ROOT / f"hintbench/configs/{name}.json").read_text())
    return cfg, load_module(ROOT / f"hintbench/configs/{name}.py", "cfg_" + name.replace(".", "_")).reference(cfg)


def test_flagship_block_counts_perfs_products_plus_biases_and_coupling():
    """PERF.md's 967,756 counts the subnets' products alone (2 a multiply-
    add). The benchmark adds what the algorithm also does: one operation a
    bias element and 5 an element of each node's lower half (atan scale,
    exp, multiply, add, log-det sum)."""
    _, flow = _flow(FLAGSHIP)
    hac = flow.ops[0][1]
    nodes = hac.nodes()
    products = sum(2 * 2 * (nd.split * nd.hidden + nd.hidden * nd.hidden + nd.hidden * (nd.dim - nd.split))
                   for nd in nodes)
    biases = sum(2 * (2 * nd.hidden + nd.dim - nd.split) for nd in nodes)
    coupling = sum(5 * (nd.dim - nd.split) for nd in nodes)
    assert products == 967_756 and len(nodes) == 71 and len(hac.levels) == 7
    assert hac_row_flops(hac) == products + biases + coupling == 981_384


def test_parameter_counts_are_the_real_nodes():
    cfg, flow = _flow(FLAGSHIP)
    from hintbench.lib import program

    model = program.config(cfg).build_model(impl="levelwise", device="cpu")
    assert sum(hac_params(op) for k, op in flow.ops if k == "hac") == sum(
        m.n_params for m in model.modules() if hasattr(m, "levels"))


def test_roofline_readers_on_a_made_up_trace():
    """A trace whose HAC kernels take exactly the bound reads 100 %; the
    kernel names are the trace's, shortened (``lib/trace.short``)."""
    from hintbench.lib.trace import short

    assert short("void (anonymous namespace)::hac_block_bwd_weights<false>(float const*, int)") == \
        "hac_block_bwd_weights<false>"
    assert short("(anonymous namespace)::hac_block_kernel(float const*, float*)") == "hac_block_kernel"
    cfg, flow = _flow(FLAGSHIP)
    from hintbench.lib.work import flow_work

    w = flow_work(flow, True)
    rows = 100 * cfg["batch_size"]
    bound = max(rows * w["hac_flops_row"] / H100["flops_f32"],
                (rows * w["hac_bytes_row"] + 100 * w["hac_bytes_call"]) / H100["bytes_per_s"])
    ctx = {"trace": {"device_ops": [("hac_block_loop_kernel<false, true>", bound / 2),
                                    ("hac_block_bwd_weights", bound / 2), ("Memcpy DtoH", 0.5)],
                     "busy_s": 2.0, "window_s": 4.0},
           "run": {"steps": 100}, "cfg": cfg, "work": w, "peaks": H100}
    read = lambda m: load_module(ROOT / f"hintbench/metrics/{m}.py", "m_" + m).read(ctx)  # noqa: E731
    assert abs(read("train_hac_roofline_pct") - 100.0) < 1e-9
    assert abs(read("train_nonhac_ms") - 5.0) < 1e-9
    assert read("train_idle_pct") == 50.0
    ctx["trace"]["device_ops"] = [("elementwise_kernel", 1.0)]
    assert read("train_hac_roofline_pct") is None
