"""Device meshes for the setup-parallel paths (counterpart of
``spaa_tpu/parallel/mesh.py``).

``spaa_tpu`` lays a 1-D ``jax.sharding.Mesh`` over its devices and lets
XLA place each array by a ``NamedSharding``. Here a mesh is the ordered
tuple of ``torch.device``s with the axis name, and placing a tree gives
one tree per device: a contiguous chunk of every leading axis
(:func:`shard_batch`) or a whole copy (:func:`replicate`). The caller runs
one host thread per device on its own tree (``parallel.multi_setup``).
"""

from __future__ import annotations

import copy
from typing import NamedTuple, Optional

import numpy as np
import torch


class Mesh(NamedTuple):
    """An ordered tuple of devices along one named axis."""
    devices: tuple
    axis: str = "data"

    @property
    def size(self) -> int:
        return len(self.devices)


class Sharding(NamedTuple):
    """How a tree is placed on a mesh: the leading axis split into
    contiguous per-device chunks (``split``), or a whole copy each."""
    mesh: Mesh
    split: bool


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              device="cuda") -> Mesh:
    """The first ``n_devices`` visible CUDA devices (default: all of them);
    raises when fewer are visible than asked. ``device="cpu"`` gives
    ``n_devices`` (default 1) entries that are all the host, for tests."""
    kind = torch.device(device).type
    if kind == "cpu":
        return Mesh((torch.device("cpu"),) * (n_devices or 1), axis)
    avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = n_devices or avail
    if n < 1 or n > avail:
        raise RuntimeError(f"a mesh of {n_devices or 'all'} CUDA devices "
                           f"was asked for and {avail} are visible; pass "
                           "device='cpu' for a host mesh")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), axis)


def batch_sharding(mesh: Mesh, axis: str = "data") -> Sharding:
    """Split the leading (batch) axis over the mesh, replicate the rest."""
    if axis != mesh.axis:
        raise ValueError(f"mesh axis is {mesh.axis!r}, not {axis!r}")
    return Sharding(mesh, True)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, False)


def _to(x, dev: torch.device):
    """One leaf on ``dev``: a tensor or array moved (no copy if it is there
    already), a module copied unless its parameters are there already."""
    if isinstance(x, torch.nn.Module):
        p = next(x.parameters(), None)
        return x if p is None or p.device == dev else copy.deepcopy(x).to(dev)
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return x


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _put(tree, sharding: Sharding) -> list:
    """The tree placed by ``sharding``: one tree per device of its mesh."""
    devs = sharding.mesh.devices
    if not sharding.split:
        return [_tree_map(lambda x, d=d: _to(x, d), tree) for d in devs]

    def chunk(x, k):
        n = x.shape[0]
        if n % len(devs):
            raise ValueError(f"leading axis {n} does not divide over the "
                             f"{len(devs)}-device mesh")
        step = n // len(devs)
        return _to(x[k * step:(k + 1) * step], devs[k])

    return [_tree_map(lambda x, k=k: chunk(x, k), tree)
            for k in range(len(devs))]


def shard_batch(tree, mesh: Mesh, axis: str = "data") -> list:
    """Every tensor's leading axis split into contiguous per-device chunks:
    one tree per device. Raises when an axis does not divide."""
    return _put(tree, batch_sharding(mesh, axis))


def replicate(tree, mesh: Mesh) -> list:
    """A whole copy of the tree on every device: one tree per device."""
    return _put(tree, replicated(mesh))


def shard_attack_inputs(mesh: Mesh, pcnet_state, clf_params, cam_scene,
                        prj_init, target_idx, targeted, weights, d_thr,
                        axis: str = "data"):
    """A batched attack placed on the mesh, in ``spaa_tpu``'s argument
    order: the frozen model state, the classifier and the scene replicated,
    the per-sample arrays split on the batch axis. Each value is a list of
    one entry per device; device k runs the attack on the k-th entries
    (SPAA normalises each sample's gradient, so a chunk's samples follow
    the same trajectory as in the whole batch)."""
    bs = batch_sharding(mesh, axis)
    rep = replicated(mesh)
    return (_put(pcnet_state, rep), _put(clf_params, rep),
            _put(cam_scene, rep), _put(prj_init, bs), _put(target_idx, bs),
            _put(targeted, bs), _put(weights, bs), _put(d_thr, bs))
