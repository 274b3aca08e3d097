"""The port's spec trees and dry-run stand-ins against the reference's.

* For every architecture: ``param_specs``, ``cache_specs`` and
  ``train_state_specs`` (AdamW, Adafactor, SGD with and without momentum)
  equal the reference's, tuple for tuple.
* For every architecture x the four shapes of ``SHAPES``: ``batch_specs``
  equal, and ``input_specs`` with the same keys, shapes and dtypes as the
  reference's ``ShapeDtypeStruct``s.
* ``abstract_params`` / ``abstract_train_state`` (``meta`` tensors) have
  the shapes and dtypes of the reference's ``jax.eval_shape`` trees.

Everything runs at full width: ``meta`` and ``eval_shape`` allocate
nothing.  Tolerance: none, every comparison is equality.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import ARCH_IDS, SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.optim import optimizers as RO  # noqa: E402
from repro_torch.configs import SHAPES  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402
from repro_torch.optim import optimizers as PO  # noqa: E402


def _schedule(step):
    return 0.0


def optimizers():
    """(name, reference optimizer, port optimizer) pairs."""
    return [
        ("adamw", RO.AdamW(schedule=_schedule),
         PO.AdamW(schedule=_schedule)),
        ("adamw_bf16", RO.AdamW(schedule=_schedule, moments_dtype="bfloat16"),
         PO.AdamW(schedule=_schedule, moments_dtype="bfloat16")),
        ("adafactor", RO.Adafactor(schedule=_schedule),
         PO.Adafactor(schedule=_schedule)),
        ("sgd", RO.Sgd(schedule=_schedule), PO.Sgd(schedule=_schedule)),
        ("sgd_momentum", RO.Sgd(schedule=_schedule, momentum=0.9),
         PO.Sgd(schedule=_schedule, momentum=0.9)),
    ]


def abstract(tree):
    """Nested dicts / lists / NamedTuples of (shape, dtype name) leaves,
    from jax ShapeDtypeStructs or torch tensors alike."""
    if isinstance(tree, dict):
        return {k: abstract(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: abstract(v) for f, v in zip(tree._fields, tree)}
    if isinstance(tree, (list, tuple)):
        return [abstract(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        assert tree.device.type == "meta", tree.device
        return tuple(tree.shape), str(tree.dtype).removeprefix("torch.")
    return tuple(tree.shape), str(np.dtype(tree.dtype))


def as_dict(state):
    return {f: v for f, v in zip(state._fields, state)}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_cache_specs_equal_the_reference(arch):
    ref, port = ref_config(arch), get_config(arch)
    assert PM.param_specs(port) == RM.param_specs(ref)
    assert PM.cache_specs(port) == RM.cache_specs(ref)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("opt", [o[0] for o in optimizers()])
def test_train_state_specs_equal_the_reference(arch, opt):
    _, ropt, popt = next(o for o in optimizers() if o[0] == opt)
    ref = RM.train_state_specs(ref_config(arch), ropt)
    port = PM.train_state_specs(get_config(arch), popt)
    assert as_dict(port) == as_dict(ref)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_are_the_reference_shapes(arch):
    ref = jax.eval_shape(lambda: RM.init(ref_config(arch),
                                         jax.random.PRNGKey(0)))
    assert abstract(PM.abstract_params(get_config(arch))) == abstract(ref)
    assert abstract(RM.abstract_params(ref_config(arch))) == abstract(ref)


@pytest.mark.parametrize("opt", [o[0] for o in optimizers()])
@pytest.mark.parametrize("arch", ["gemma3-12b", "whisper-tiny",
                                  "olmoe-1b-7b", "xlstm-350m",
                                  "hymba-1.5b"])
def test_abstract_train_state_is_the_reference_shapes(arch, opt):
    _, ropt, popt = next(o for o in optimizers() if o[0] == opt)
    ref = RM.abstract_train_state(ref_config(arch), ropt)
    port = PM.abstract_train_state(get_config(arch), popt)
    assert abstract(port) == abstract(ref)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape", list(REF_SHAPES))
def test_batch_and_input_specs_equal_the_reference(arch, shape):
    ref_cfg, port_cfg = ref_config(arch), get_config(arch)
    assert PM.batch_specs(port_cfg, SHAPES[shape]) == \
        RM.batch_specs(ref_cfg, REF_SHAPES[shape])
    ref = RM.input_specs(ref_cfg, REF_SHAPES[shape])
    port = PM.input_specs(port_cfg, SHAPES[shape])
    assert abstract(port) == abstract(ref)
    # the spec tree covers every input
    assert _keys(PM.batch_specs(port_cfg, SHAPES[shape])) == _keys(port)


def _keys(tree, prefix=()):
    if isinstance(tree, dict):
        return {p for k, v in tree.items() for p in _keys(v, prefix + (k,))}
    return {prefix}
