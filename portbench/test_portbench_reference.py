"""The benchmark's plain reference: against the port's pod aggregation on
CPU tensors (where the port runs its kernels' plain versions), against
values worked out by hand, and its control in a lower precision."""

import pytest
import torch

from portbench.reference import fl_aggregate as reference
from repro_torch.distributed import fl_mesh

#: a 16-wide, a 64-wide and a >8,192-wide leaf, and a 1-d one
SHAPES = {"narrow": (3, 16), "router": (2, 5, 64), "unembed": (2, 9000),
          "norm": (40,)}


def stacked_tree(pods: int, seed: int = 0) -> dict:
    gen = torch.Generator().manual_seed(seed)
    tree = {}
    for name, shape in SHAPES.items():
        base = torch.randn(shape, generator=gen) * 0.02
        tree[name] = torch.stack([
            (base + 0.01 * torch.randn(shape, generator=gen))
            .to(torch.bfloat16) for _ in range(pods)])
    return tree


@pytest.mark.parametrize("pods", [2, 4])
@pytest.mark.parametrize("mode", ["exact", "int8"])
def test_reference_is_the_ports_aggregation(mode, pods):
    tree = stacked_tree(pods, seed=pods)
    agg = fl_mesh.make_fl_aggregate(
        fl_mesh.client_mesh([torch.device("cpu")]), mode=mode)
    out = agg(tree)
    assert reference.judge(tree, out, mode) == {"mismatch_share": 0.0,
                                                "max_gap_ulp": 0.0}
    ref = reference.aggregate(tree, mode, block_values=100)
    for name, x in tree.items():
        assert ref[name].dtype == x.dtype and ref[name].shape == x.shape
        assert torch.equal(ref[name], out[name])


def test_exact_mean_by_hand():
    x = torch.tensor([[1.0, -2.0], [2.0, 0.5], [4.0, 0.25], [5.0, -0.75]],
                     dtype=torch.bfloat16).view(4, 1, 2)
    got = reference.mean_rows(x, "exact")
    assert torch.equal(got, torch.tensor([[3.0, -0.5]]))


def test_int8_round_trip_by_hand():
    # absmax 1: scale 1/127; 0.5 * 127 = 63.5 rounds to the even 64,
    # -0.25 * 127 = -31.75 to -32
    x = torch.tensor([[1.0, 0.5, -0.25, 0.0]]).view(1, 1, 4)
    scale = torch.tensor(1.0) / torch.tensor(127.0)
    want = torch.tensor([127.0, 64.0, -32.0, 0.0]) * scale
    assert torch.equal(reference.mean_rows(x, "int8")[0], want)
    # a zero row keeps its floor scale and decodes to zeros
    zeros = torch.zeros(2, 1, 8)
    assert torch.equal(reference.mean_rows(zeros, "int8"),
                       torch.zeros(1, 8))


def test_spacing():
    m = torch.tensor([1.0, 0.75, 3.0, 0.0])
    got = reference.spacing(m, torch.bfloat16)
    tiny = torch.finfo(torch.bfloat16).tiny * 2 ** -7
    assert got.tolist() == [2 ** -7, 2 ** -8, 2 ** -6, tiny]


def test_judge_counts_one_altered_value():
    tree = stacked_tree(4)
    out = reference.aggregate(tree, "exact")
    row = out["unembed"][1, 0]
    peak = float(row.abs().max())
    i = int(row.abs().argmin())
    row[i] = row[i] + float(reference.spacing(torch.tensor(peak),
                                              torch.bfloat16))
    got = reference.judge(tree, out, "exact")
    n = sum(x.numel() for x in tree.values())
    assert got["mismatch_share"] == pytest.approx(1 / n)
    assert 0.5 <= got["max_gap_ulp"] <= 1.5


def test_judge_refuses_a_missing_or_misshapen_leaf():
    tree = stacked_tree(2)
    out = reference.aggregate(tree, "exact")
    worst = {"mismatch_share": 1.0, "max_gap_ulp": reference.WORST_GAP}
    assert reference.judge(tree, {k: v for k, v in out.items()
                                  if k != "norm"}, "exact") == worst
    out["norm"] = out["norm"].to(torch.float32)
    assert reference.judge(tree, out, "exact") == worst


@pytest.mark.parametrize("mode,pods,arith", [
    ("exact", 4, torch.bfloat16), ("int8", 4, torch.bfloat16),
    ("int8", 2, torch.bfloat16), ("exact", 2, torch.float8_e4m3fn)])
def test_control_fails(mode, pods, arith):
    tree = stacked_tree(pods, seed=7)
    control = reference.aggregate(tree, mode, arith=arith)
    assert reference.judge(tree, control, mode)["mismatch_share"] > 0.1


def test_bf16_mean_of_two_pods_is_one_rounding():
    # why the 2-pod exact cell's control is fp8: a bf16 mean of two bf16
    # values rounds once, as the float32 mean cast back does
    tree = stacked_tree(2, seed=3)
    control = reference.aggregate(tree, "exact", arith=torch.bfloat16)
    assert reference.judge(tree, control, "exact") == {
        "mismatch_share": 0.0, "max_gap_ulp": 0.0}
