"""Step kind ``fl_aggregate``: one FL aggregation round of the port's
pod-axis FedAvg, ``repro_torch.distributed.fl_mesh.make_fl_aggregate``,
on a stacked parameter tree of plain tensors in this process.

The configuration gives the leaves (name, shape, dtype) and the pod
count; the traffic gives the mode (``exact`` or ``int8``), how many input
trees the window alternates over, the values' distribution and the
warm-up rounds.  Each tree is drawn from the seed on the device: every
leaf a base of N(0, ``base_std``) plus each pod's own N(0, ``pod_std``),
in float32, then cast to the leaf's dtype.  A round is one call on the
next tree; the harness sends the next round without waiting for the
device, which runs them in order on one stream.  A round's output is
released before the next round starts (the allocator reuses it in the
stream's order), so the last round's output is the one left to judge.
"""

from __future__ import annotations

import torch

from portbench import work
from portbench.reference import fl_aggregate as reference

#: the comparison's numbers, as ``judge()`` names them
CHECKS = ("mismatch_share", "max_gap_ulp")
DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def leaf_operands(config: dict) -> list[work.Operand]:
    """The configuration's leaves, one pod's copy each."""
    return [work.Operand(tuple(shape), DTYPES[dtype].itemsize)
            for _, shape, dtype in config["leaves"]]


class Step:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from repro_torch.distributed import fl_mesh
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.mode = traffic["mode"]
        self.pods = int(config["pods"])
        self.aggregate = fl_mesh.make_fl_aggregate(fl_mesh.client_mesh(),
                                                   mode=self.mode)
        self.inputs: list[dict] = []
        self.out = None
        self.last = None

    @property
    def n_inputs(self) -> int:
        return int(self.traffic["inputs"])

    def _tree(self, gen: torch.Generator) -> dict:
        base_std = float(self.traffic["base_std"])
        pod_std = float(self.traffic["pod_std"])
        tree = {}
        for name, shape, dtype in self.config["leaves"]:
            shape = tuple(shape)
            base = torch.randn(shape, generator=gen, device=self.device)
            base.mul_(base_std)
            stack = torch.empty((self.pods,) + shape, dtype=DTYPES[dtype],
                                device=self.device)
            for pod in stack:
                noise = torch.randn(shape, generator=gen, device=self.device)
                pod.copy_(noise.mul_(pod_std).add_(base))
                del noise
            tree[name] = stack
            del base
        return tree

    def setup(self) -> None:
        """Draw the input trees from the seed, on the device."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed % (1 << 64))
        self.inputs = [self._tree(gen) for _ in range(self.n_inputs)]

    def warm_rounds(self) -> int:
        """Rounds of warm-up: ``warmup_rounds`` on each input tree."""
        return int(self.traffic["warmup_rounds"]) * self.n_inputs

    def run(self, i: int) -> None:
        """Round ``i``: the aggregate of input tree ``i mod n_inputs``."""
        self.out = None
        self.last = i % self.n_inputs
        self.out = self.aggregate(self.inputs[self.last])

    def close(self) -> None:
        """Keep only the last round's input and output."""
        self.inputs = [t if j == self.last else None
                       for j, t in enumerate(self.inputs)]

    def judge(self) -> dict:
        """The comparison of the last round's output with the reference."""
        return reference.judge(self.inputs[self.last], self.out, self.mode)

    def control(self, arith) -> None:
        """Put the reference, computed in ``arith``, in the program's
        place for the last round's input."""
        self.out = None
        self.out = reference.aggregate(self.inputs[self.last], self.mode,
                                       arith=arith)

    def round_work(self) -> tuple[int, int, float]:
        """The round's least bytes and operations, and the peak those
        operations run at: the mean's float32 adds, which are negligible
        beside the bytes, so the round is bytes-bound."""
        return (work.round_bytes(leaf_operands(self.config), self.pods), 0,
                work.PEAK_F32_FLOPS)
