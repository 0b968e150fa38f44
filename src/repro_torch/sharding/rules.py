"""Name-based placement rules for every architecture.

A copy of ``repro.sharding.rules``. Each function returns, for every leaf
of a params (or batch, or decode-state) tree, a plain tuple with one entry
per dim: ``None``, a mesh axis name, or a tuple of names. The rules read a
mesh's ``axis_names`` and ``shape`` only, so a shape-only stand-in serves
(the tests hand both packages the same one). Trees are nested dicts (the
port's params trees); a leaf is anything with a ``shape``.

Strategy (the reference's):
  * model axis ("model") = tensor parallel: attention projections on the
    fused head dim, MLP on d_ff, mamba2's inner dim, embedding and
    unembedding on the vocab (non-dividing vocabs shard d instead);
  * expert axis: MoE expert tensors over the EP axis ("data") plus
    "model" on d_ff;
  * batch: the data axes; in FL mode the leading client-stack axis takes
    the client axes instead;
  * decode caches: KV over batch (data) and sequence ("model"), SSM
    states over SSM heads.
"""
from __future__ import annotations

from typing import Optional, Tuple


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts and lists; None is an empty
    subtree, as in JAX."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _base_spec(keys: Tuple[str, ...], shape: Tuple[int, ...], cfg,
               ep_axis: Optional[str], axis_sizes: dict,
               tp: Optional[str] = "model") -> tuple:
    """Spec of the TRAILING dims of one leaf (the caller prepends the
    stack dims). A non-dividing assignment falls back (vocab -> d; small
    expert counts -> expert d over the EP axis), and a final guard drops
    any that still does not divide."""
    ndim = len(shape)

    def ok(dim_from_end: int, axis) -> bool:
        if axis is None:
            return True
        return shape[ndim - dim_from_end] % axis_sizes.get(axis, 1) == 0

    def pad(spec: tuple) -> tuple:
        spec = (None,) * (ndim - len(spec)) + spec
        return tuple(a if (a is None or shape[i] % axis_sizes.get(a, 1) == 0)
                     else None for i, a in enumerate(spec))

    leaf = keys[-1]
    if "moe" in keys:
        if "router" in keys:
            return pad((None, None))
        e_div = ok(3, ep_axis) if ndim >= 3 else False
        if leaf in ("gate", "up"):          # (E, d, ff)
            if e_div:
                return pad((ep_axis, None, tp))
            return pad((None, ep_axis, tp))
        if leaf == "down":                  # (E, ff, d)
            if e_div:
                return pad((ep_axis, tp, None))
            return pad((None, tp, ep_axis))
    if "mamba" in keys:
        if leaf == "in_proj":               # (d, 2*din+2gn+h)
            return pad((None, tp))
        if leaf == "conv_w":                # (K, dxbc)
            return pad((None, tp))
        if leaf == "out_proj":              # (din, d)
            return pad((tp, None))
        if leaf == "norm_scale":            # (din,)
            return pad((tp,))
        return pad(())
    if leaf == "embed":                     # (V, d)
        if ok(2, tp):
            return pad((tp, None))
        return pad((None, tp))
    if leaf == "unembed":                   # (d, V)
        if ok(1, tp):
            return pad((None, tp))
        return pad((tp, None))
    if ("attn" in keys or "shared_attn" in keys) and len(keys) >= 2:
        parent = keys[-2]
        if parent in ("wq", "wk", "wv"):    # (d, H*hd)
            return pad((None, tp))
        if parent == "wo":                  # (H*hd, d)
            return pad((tp, None))
    if "mlp" in keys and len(keys) >= 2:
        parent = keys[-2]
        if parent in ("gate", "up"):        # (d, ff)
            return pad((None, tp))
        if parent == "down":                # (ff, d)
            return pad((tp, None))
    if cfg is None and tp is not None and axis_sizes.get(tp, 1) > 1:
        # a structureless tree under an active TP axis: the LAST
        # tp-divisible trailing dim; nothing divides -> replicated
        for i in range(ndim - 1, -1, -1):
            if shape[i] > 1 and shape[i] % axis_sizes[tp] == 0:
                return pad((None,) * i + (tp,) + (None,) * (ndim - 1 - i))
    return pad(())


def param_specs(params_shape, cfg, mesh, ep_axis: Optional[str] = "data",
                stack_axes: Tuple = (), tp_axis: Optional[str] = "model"):
    """The spec tree of ``params_shape``. ``stack_axes``: mesh axes of a
    leading client-stack dim. ``cfg=None`` is a structureless tree (the
    MLP): its paths fall through to replicated trailing dims."""
    ep = ep_axis if ep_axis in mesh.axis_names else None
    tp = tp_axis if (tp_axis in mesh.axis_names
                     and tp_axis not in stack_axes) else None
    sizes = dict(mesh.shape)
    lead = ((stack_axes if len(stack_axes) != 1 else stack_axes[0]),) \
        if stack_axes else ()

    def one(path, leaf):
        shape = tuple(leaf.shape)
        if stack_axes:
            return lead + _base_spec(path, shape[1:], cfg, ep, sizes, tp)
        return _base_spec(path, shape, cfg, ep, sizes, tp)

    return _map_with_path(one, params_shape)


def stack_client_specs(params_shape, cfg, mesh, client_axes,
                       ep_axis: Optional[str] = None,
                       tp_axis: Optional[str] = None):
    """Specs of client-stacked (K, ...) params: TP over ``tp_axis``
    (default the mesh's "tp" axis when it is no client axis, else
    "model"), EP over ``ep_axis`` only where it is no client axis."""
    ep = ep_axis
    if ep is None:
        ep = "data" if ("data" in mesh.axis_names
                        and "data" not in client_axes) else None
    tp = tp_axis
    if tp is None:
        tp = "tp" if ("tp" in mesh.axis_names
                      and "tp" not in client_axes) else "model"
    return param_specs(params_shape, cfg, mesh, ep_axis=ep,
                       stack_axes=tuple(client_axes), tp_axis=tp)


def batch_specs(batch_shape, dp_axes: Tuple[str, ...],
                lead_axes: Tuple = ()):
    """Batch tree: the leading stack dims (client K, local steps M), then
    the per-step batch dim over ``dp_axes``."""
    dp = (dp_axes if len(dp_axes) != 1 else dp_axes[0]) if dp_axes else None

    def entry(a):
        if isinstance(a, tuple):
            if len(a) == 0:
                return None
            return a if len(a) != 1 else a[0]
        return a

    lead = tuple(entry(a) for a in lead_axes)

    def one(_, leaf):
        nd = len(leaf.shape)
        spec = lead + (dp,) + (None,) * (nd - len(lead) - 1)
        return spec[:nd]

    return _map_with_path(one, batch_shape)


def decode_state_specs(state_shape, cfg, mesh, dp_axes: Tuple[str, ...]):
    """KV caches (L, B, S, Hkv, hd): B over dp, S over "model". SSM states
    (L, B, H, P, N): H over "model". conv (L, B, K-1, dxbc): dxbc over
    "model". Batch-1 shapes keep dp None."""
    def one(path, leaf):
        nd = len(leaf.shape)
        b = leaf.shape[1] if nd > 1 else 1
        dp = None
        if dp_axes and b >= 2:
            dp = dp_axes if len(dp_axes) != 1 else dp_axes[0]
        if path[-1] in ("k", "v"):
            return (None, dp, "model", None, None)
        if path[-1] in ("k_scale", "v_scale"):
            return (None, dp, "model", None)
        if path[-1] == "ssm":
            return (None, dp, "model", None, None)
        if path[-1] == "conv":
            return (None, dp, None, "model")
        return (None,) * nd

    return _map_with_path(one, state_shape)
