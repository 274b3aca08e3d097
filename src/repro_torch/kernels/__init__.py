"""Hand-written CUDA kernels for Hopper (``sm_90a``), one family per folder.

Each family has ``csrc/*.cu`` (the kernel and a plain C launcher, built by
:mod:`repro_torch.kernels._build` and loaded with ``ctypes``), ``ref.py``
(the plain PyTorch version of the same function) and ``ops.py`` (the
wrapper: it checks its inputs, runs the kernel on a CUDA tensor and the
plain version on a CPU tensor, and never falls back from one to the other).

``launch_counts[name]`` grows by one each time a wrapper launches its
kernel, and nowhere else, so a run can show that its path went through
the kernels; :func:`reset_launch_counts` zeroes them.  A route may count
under a key of its own as well: ``fedavg_pods``, the fedavg launches of
the pod route (also counted under ``fedavg``).

A kernel that cannot be built, loaded or launched raises
:class:`KernelError`.  It is not a malformed payload: the wire plane lets
it through its decode-error degradation, so a round stops instead of
folding zero-filled rows.
"""

from __future__ import annotations


class KernelError(RuntimeError):
    """A kernel (or the device it runs on) failed; never degraded."""


launch_counts: dict[str, int] = {"fedavg": 0, "fedavg_pods": 0, "quantize": 0,
                                 "dequantize": 0, "topk_gather": 0,
                                 "topk_scatter": 0, "checksum": 0,
                                 "flash_attention": 0, "mlstm": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
