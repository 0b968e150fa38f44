"""The port's placement rules (``repro_torch.sharding.rules``) against the
reference's (``repro.sharding.rules``): for every architecture of
``repro.configs``, on the shape-only meshes of tests/test_sharding_specs.py
(``("data", "model")`` layouts of 1, 2 and 8 "devices") and on
``("pod", "data", "tp")`` meshes, ``stack_client_specs`` and
``batch_specs`` give every leaf the same per-dim axes, and
``client_axes_for`` picks the same client axes. Both packages read only a
mesh's ``axis_names`` and ``shape``, so one stand-in serves both."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCH_IDS, get_config  # noqa: E402
from repro.launch.mesh import client_axes_for  # noqa: E402
from repro.launch.shapes import InputShape  # noqa: E402
from repro.launch.steps import abstract_params, train_batch_struct  # noqa: E402
from repro.sharding.rules import batch_specs, stack_client_specs  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.sharding import rules as trules  # noqa: E402

# tests/test_sharding_specs.py's layouts, and TP meshes (pods, data, tp)
LAYOUTS = [(1, 1), (2, 1), (1, 2), (8, 1), (2, 4), (1, 8)]
TP_LAYOUTS = [(1, 2, 2), (2, 2, 4), (1, 1, 8)]
SHAPE = InputShape("spec_test", seq_len=128, global_batch=64, kind="train")


class _Mesh:
    """Shape-only mesh stand-in."""

    def __init__(self, **axes):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)
        self.size = int(np.prod(list(axes.values())))


class _Shape:
    def __init__(self, shape):
        self.shape = tuple(shape)


@functools.lru_cache(maxsize=None)
def _base(arch):
    return abstract_params(get_config(arch))


def _keyed(path):
    return tuple(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def _port_tree(tree, stack):
    """The reference's struct tree as the port's: nested dicts and lists
    of shape-only leaves, with the client-stack dim in front."""
    if isinstance(tree, dict):
        return {k: _port_tree(v, stack) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_port_tree(v, stack) for v in tree]
    if tree is None:
        return None
    return _Shape((stack,) + tuple(tree.shape) if stack else tree.shape)


def _ref_specs(specs):
    out = {}
    for path, spec in jax.tree_util.tree_leaves_with_path(
            specs, is_leaf=lambda s: isinstance(s,
                                                jax.sharding.PartitionSpec)):
        out[_keyed(path)] = tuple(spec)
    return out


def _port_specs(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_specs(v, path + (str(k),)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_specs(v, path + (str(i),)))
        return out
    if tree is None:
        return {}
    return {path: tuple(tree)}


def _check(arch, mesh, client_axes):
    n_client = int(np.prod([mesh.shape[a] for a in client_axes])) or 1
    k = 2 * n_client
    cfg = get_config(arch)
    ref_tree = jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct((k,) + s.shape, s.dtype),
        _base(arch))
    want = _ref_specs(stack_client_specs(ref_tree, cfg, mesh, client_axes))
    got = _port_specs(trules.stack_client_specs(
        _port_tree(_base(arch), k), cfg, mesh, client_axes))
    assert got == want
    batch = train_batch_struct(cfg, SHAPE, k, local_steps=3)
    lead = (tuple(client_axes) if client_axes else (), ())
    want = _ref_specs(batch_specs(batch, (), lead_axes=lead))
    got = _port_specs(trules.batch_specs(_port_tree(batch, 0), (),
                                         lead_axes=lead))
    assert got == want
    return want


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_specs_equal_reference_on_data_model_meshes(arch, layout):
    mesh = _Mesh(data=layout[0], model=layout[1])
    cfg = get_config(arch)
    axes = client_axes_for(cfg, mesh)
    assert tmesh.client_axes_for(cfg, mesh) == axes
    _check(arch, mesh, axes)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("layout", TP_LAYOUTS)
def test_specs_equal_reference_on_tp_meshes(arch, layout):
    mesh = _Mesh(pod=layout[0], data=layout[1], tp=layout[2])
    axes = tmesh.data_axes(mesh)
    assert axes == ("pod", "data")
    _check(arch, mesh, axes)


def test_structureless_tree_takes_the_last_dividing_dim():
    """The MLP (``cfg=None``) under TP: each leaf's last dim that the TP
    extent divides, none where nothing divides (the leaf stays
    replicated), as the reference; the sharded round reads its TP split
    off these specs."""
    mlp = {"l1": {"w": (784, 10), "b": (10,)},
           "l2": {"w": (10, 10), "b": (10,)}}
    for tp, want in ((2, {("l1", "w"): 2, ("l1", "b"): 1, ("l2", "w"): 2,
                          ("l2", "b"): 1}),
                     (4, {("l1", "w"): 1, ("l1", "b"): None,
                          ("l2", "w"): None, ("l2", "b"): None})):
        mesh = _Mesh(pod=1, data=2, tp=tp)
        tree = {a: {b: _Shape((4,) + s) for b, s in v.items()}
                for a, v in mlp.items()}
        specs = _port_specs(trules.stack_client_specs(
            tree, None, mesh, ("pod", "data")))
        for path, dim in want.items():
            spec = specs[path]
            assert spec[0] == ("pod", "data")
            assert [i for i, a in enumerate(spec) if a == "tp"] == (
                [] if dim is None else [dim])
