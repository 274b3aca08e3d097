"""The yardstick's arithmetic, pinned for the benchmark's two
configurations, and the configuration files held to their totals."""

import json
from pathlib import Path

import pytest
import torch

from portbench import work
from portbench.steps import fl_aggregate

HERE = Path(__file__).resolve().parent


def config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name,pods,leaves,n,nbytes", [
    ("hymba-1.5b.pod4", 4, 28, 1_524_741_824, 24_395_869_184),
    ("olmoe-1b-7b.pod2", 2, 15, 3_563_128_832, 28_505_030_656)])
def test_config_totals_and_round_bytes(name, pods, leaves, n, nbytes):
    cfg = config(name)
    ops = fl_aggregate.leaf_operands(cfg)
    assert cfg["pods"] == pods and len(ops) == leaves == cfg["leaf_count"]
    assert work.params_per_pod(ops) == n == cfg["params_per_pod"]
    # bf16 leaves: 4 P N bytes (the stack read once, P copies written)
    assert work.round_bytes(ops, pods) == nbytes == 4 * pods * n
    assert all(d == "bfloat16" for _, _, d in cfg["leaves"])


def test_olmoe_cut_and_the_deployment():
    cfg = config("olmoe-1b-7b.pod2")
    assert cfg["num_hidden_layers"] == 8
    assert cfg["published"]["num_hidden_layers"] == 16
    assert set(cfg["reduced"]) == {"num_hidden_layers"}
    # the layer leaves scale with the depth; the rest do not
    ops = fl_aggregate.leaf_operands(cfg)
    per_layer = sum(o.numel for (name, _, _), o in zip(cfg["leaves"], ops)
                    if name.startswith("layers/")) // 8
    rest = work.params_per_pod(ops) - 8 * per_layer
    assert rest + 16 * per_layer == 6_919_686_144 == \
        cfg["params_per_pod_published"]
    shapes = dict((k, s) for k, s, _ in cfg["leaves"])
    assert shapes["layers/we_gate"] == [8, 64, 2048, 1024]
    # QK-norm over the whole 16 x 128 query and key projections
    assert shapes["layers/q_norm"] == shapes["layers/k_norm"] == [8, 2048]


def test_hymba_is_not_cut():
    """Every width of the published config, on the leaves that carry it."""
    cfg = config("hymba-1.5b.pod4")
    assert cfg["reduced"] == {} and cfg["num_hidden_layers"] == 32
    d, inner = cfg["hidden_size"], cfg["mamba_expand"] * cfg["hidden_size"]
    rank, state = cfg["mamba_dt_rank"], cfg["mamba_d_state"]
    heads, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    shapes = dict((k, s) for k, s, _ in cfg["leaves"])
    assert (inner, rank, state) == (3200, 100, 16)
    assert shapes["layers/w_in"] == shapes["layers/w_gate_ssm"] == \
        [32, d, inner]
    assert shapes["layers/w_out"] == [32, inner, d]
    assert shapes["layers/ssm/w_dt"] == [32, inner, rank]
    assert shapes["layers/ssm/dt_proj"] == [32, rank, inner]
    assert shapes["layers/ssm/A_log"] == shapes["layers/ssm/w_B"] == \
        [32, inner, state]
    assert shapes["layers/ssm/conv_w"] == [32, cfg["mamba_d_conv"], inner]
    assert shapes["memory_tokens"] == [cfg["num_memory_tokens"], d]
    assert shapes["layers/wq"] == [32, d, heads, cfg["head_dim"]]
    assert shapes["layers/kv/wv"] == [18, d, kv, cfg["v_head_dim"]]
    # the attention's output meets the SSM branch's at the fused norms
    assert heads * cfg["v_head_dim"] == inner
    assert shapes["layers/w_gate"] == [32, d, cfg["intermediate_size"]]


@pytest.mark.parametrize("name", ["hymba-1.5b.pod4", "olmoe-1b-7b.pod2"])
def test_kernel_work_is_chip_smokes_figures(name):
    """int8, summed over a round's calls: the bytes chip_smoke's phase
    14(a) counts (float32 stacks and means, int8 codes, a float32 scale a
    row) and fedavg's K float32 weights a call beside them."""
    cfg = config(name)
    pods = cfg["pods"]
    fed, quant, deq = [0, 0], [0, 0], [0, 0]
    rows = 0
    for _, shape, _ in cfg["leaves"]:
        n = 1
        for s in shape:
            n *= s
        d = shape[-1] if len(shape) > 1 else n
        r = pods * n // d
        rows += n // d
        stack = [work.Operand((r, d), 4)]
        codes = [work.Operand((r, d), 1), work.Operand((r, 1), 4)]
        f = work.fedavg_work([work.Operand((pods, n), 4),
                              work.Operand((pods,), 4)],
                             [work.Operand((n,), 4)])
        q = work.quantize_work(stack, codes)
        dq = work.dequantize_work(codes, stack)
        for acc, w in ((fed, f), (quant, q), (deq, dq)):
            acc[0] += w[0]
            acc[1] += w[1]
    per_pod = cfg["params_per_pod"]
    stacked = pods * per_pod
    assert fed == [4 * (pods + 1) * per_pod + 4 * pods * cfg["leaf_count"],
                   2 * stacked]
    assert quant == [5 * stacked + 4 * pods * rows, 2 * stacked]
    assert deq == quant[:1] + [stacked]
    if name == "hymba-1.5b.pod4":
        assert fed[0] == 30_494_836_928 and quant[0] == 30_534_787_856


def test_bound():
    assert work.bound_s(int(3.35e12), 0) == (1.0, "bytes")
    assert work.bound_s(0, int(67e12)) == (1.0, "operations")
    assert work.operand(torch.zeros(2, 3)) == work.Operand((2, 3), 4)


def test_bound_at_the_bf16_peak():
    """Operations on the tensor cores in bf16, at the data sheet's dense
    989 TFLOP/s: 989e12 of them take a second, as 67e12 do at the float32
    peak that a call takes where it names none."""
    assert work.PEAK_BF16_FLOPS == 989e12
    assert work.bound_s(0, int(989e12), work.PEAK_BF16_FLOPS) == (
        1.0, "operations")
    seconds, which = work.bound_s(0, int(989e12))
    assert seconds == pytest.approx(989 / 67) and which == "operations"
    # an 8192 x 4096 x 4096 bf16 matmul: 2.75e11 operations, 167.8 MB
    flops, nbytes = 2 * 8192 * 4096 * 4096, 2 * (2 * 8192 * 4096 + 4096 ** 2)
    assert work.bound_s(nbytes, flops, work.PEAK_BF16_FLOPS) == (
        flops / 989e12, "operations")
    assert work.bound_s(nbytes, 0, work.PEAK_BF16_FLOPS) == (
        nbytes / 3.35e12, "bytes")
