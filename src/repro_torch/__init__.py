"""PyTorch/CUDA port of the Modified-UDP federated-learning system.

The JAX package ``repro`` is the reference this package is held against;
this package never imports it (or JAX).  The layout mirrors the
reference: ``core`` (wire plane, transports, simulator, orchestration),
``kernels`` (hand-written CUDA kernels for Hopper with their plain PyTorch
versions), ``models`` and ``data``.  Everything runs on ``cuda`` unless
the caller asks for another device (:mod:`repro_torch.device`).
"""

from repro_torch.device import default_device, resolve, use_device

__all__ = ["default_device", "resolve", "use_device"]
