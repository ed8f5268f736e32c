"""Leaf-by-leaf comparison of port trees against the JAX reference.

The port's tensors go through ``repro_torch.interop.to_numpy`` (the one
dtype map), then every leaf of the reference tree is compared exactly,
dtype included; a failure names the leaf path, as
``test_parity_fuzz._assert_trees_equal`` does for the reference's own
twins.  Every NamedTuple of the port compares this way (the simulator's
carry, the tracker, the controller's ``TracedUpdate``); a plain tuple
(NoCache's empty policy ``()``) is walked item by item, so an empty one
holds no leaf and the port must hold none there either; leaves that are
already numpy (a period's stacked updates) pass through unchanged.
"""
from __future__ import annotations

import numpy as np

from repro_torch.interop import to_numpy


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves_with_path(tree, prefix=""):
    """[(path, leaf)] of a tree of NamedTuples and tuples, in order."""
    if _is_namedtuple(tree):
        out = []
        for f in tree._fields:
            out += tree_leaves_with_path(getattr(tree, f), f"{prefix}.{f}")
        return out
    if isinstance(tree, tuple):
        out = []
        for i, v in enumerate(tree):
            out += tree_leaves_with_path(v, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def assert_trees_equal(port, ref, label: str, skip=("rng", "draws"),
                       tolerate=None):
    """Every leaf of ``ref`` equals the same-path leaf of ``port``.

    ``tolerate`` maps a leaf path suffix to a checker ``fn(got, want, path)``
    that replaces exact equality for that leaf (the test states why).
    """
    got = dict(tree_leaves_with_path(to_numpy(port)))
    want = tree_leaves_with_path(ref)
    assert want, f"{label}: empty reference tree"
    named = lambda paths: {p for p in paths
                           if p.rsplit(".", 1)[-1] not in skip}
    extra = named(got) - named(p for p, _ in want)
    assert not extra, f"{label}: port leaves the reference lacks: {extra}"
    for path, w in want:
        if path.rsplit(".", 1)[-1] in skip:
            continue
        assert path in got, f"{label}: port has no leaf {path}"
        g, w = np.asarray(got[path]), np.asarray(w)
        assert g.dtype == w.dtype, \
            f"{label}: dtype mismatch at {path}: {g.dtype} vs {w.dtype}"
        assert g.shape == w.shape, \
            f"{label}: shape mismatch at {path}: {g.shape} vs {w.shape}"
        check = next((fn for suf, fn in (tolerate or {}).items()
                      if path.endswith(suf)), None)
        if check is not None:
            check(g, w, f"{label}{path}")
        else:
            np.testing.assert_array_equal(
                g, w, err_msg=f"{label}: mismatch at {path}")


def flat_tree(tree, prefix=""):
    """{path: numpy leaf} of a port tree, with the reference's dtypes (the
    form a reference subprocess dumps into an ``.npz``)."""
    return dict(tree_leaves_with_path(to_numpy(tree), prefix))


def tree_from_flat(template, flat, device, prefix=""):
    """A port tree shaped as ``template`` whose leaves are ``flat[path]``
    (reference numpy arrays, as :func:`flat_tree` names them), through the
    interop dtype map."""
    from repro_torch.interop import from_numpy
    if _is_namedtuple(template):
        return type(template)(*(
            tree_from_flat(getattr(template, f), flat, device,
                           f"{prefix}.{f}") for f in template._fields))
    return from_numpy(flat[prefix], device, prefix.rsplit(".", 1)[-1])


def assert_flat_equal(port, flat, label, prefix=""):
    """``port`` (a port tree) equals the reference leaves ``flat`` stored
    under ``prefix``, leaf for leaf and dtype for dtype; returns the count."""
    got = flat_tree(port)
    want = {k[len(prefix):]: v for k, v in flat.items()
            if k.startswith(prefix + ".")}
    assert set(got) == set(want), \
        f"{label}: leaves differ: {set(got) ^ set(want)}"
    for path, w in want.items():
        g = got[path]
        assert g.dtype == w.dtype and g.shape == w.shape, \
            f"{label}{path}: {g.dtype}{g.shape} vs {w.dtype}{w.shape}"
        np.testing.assert_array_equal(g, w, err_msg=f"{label}{path}")
    return len(want)
