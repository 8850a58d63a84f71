"""The port's input stand-ins (``repro_torch.launch.inputs``) against the
reference's ``repro.launch.inputs``.

For every (assigned arch, ``INPUT_SHAPES`` entry): the same
:class:`ShapeSkip` pairs, and otherwise the same step kind, window and
argument trees, whose ``meta`` tensors have the shapes and dtypes of the
reference's ``ShapeDtypeStruct``\\ s leaf by leaf (dict keys in sorted
order, as JAX flattens them).  Nothing is allocated on either side.
"""
import jax
import pytest

from repro.configs import ASSIGNED_ARCHS, INPUT_SHAPES
from repro.configs import get_config as j_get_config
from repro.launch import inputs as JI

from repro_torch.configs import get_config
from repro_torch.launch import inputs as PI
from _torch_threads import one_torch_thread  # noqa: F401


def flat(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in flat(v)]
    return [tree]


def structs(tree) -> list:
    return [(tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for x in flat(tree)]


@pytest.mark.parametrize("shape", sorted(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_input_specs_match_reference(arch, shape):
    j_cfg, cfg = j_get_config(arch), get_config(arch)
    try:
        ref = JI.input_specs(j_cfg, shape)
    except JI.ShapeSkip:
        with pytest.raises(PI.ShapeSkip, match="long_500k"):
            PI.input_specs(cfg, shape)
        return
    spec = PI.input_specs(cfg, shape)
    assert (spec.step_kind, spec.window) == (ref.step_kind, ref.window)
    assert spec.shape.name == shape and spec.cfg is cfg
    assert all(x.device.type == "meta" for x in flat(spec.args))
    assert structs(spec.args) == [(tuple(x.shape), str(x.dtype))
                                  for x in jax.tree.leaves(ref.args)]
