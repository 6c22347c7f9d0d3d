"""Production mesh layouts + logical-axis resolution, as data.

Port of the JAX package's ``launch/mesh.py``.  The reference builds a
``jax.sharding.Mesh`` of 256 or 512 devices; this module describes
the same layouts without devices: a :class:`MeshLayout` is axis names
and sizes, and :class:`PartitionSpec` a tuple of per-dimension entries
(``None``, an axis name, or a tuple of axis names).  Single-pod:
(data=16, model=16) = 256 devices.  Multi-pod: (pod=2, data=16,
model=16) = 512 — the pod axis extends the data/FSDP dimension.

Model code writes specs against *logical* axes (``AX_DATA`` = ("pod",
"data") and ``AX_MODEL`` = "model"); :func:`resolve_specs` drops axes a
layout does not have, so the same spec tree serves both layouts, and
:func:`fit_spec` drops axes (rightmost first within each dim) until
every dim divides, as the reference's ``fit_spec`` does for pjit.
:func:`shard_shape` is the per-device shape of a leaf under its fitted
spec, so the port can count the per-device bytes of a step on a layout
it cannot run.  The port runs on one device: :func:`require_devices`
raises for any other layout size, as the reference's
``make_production_mesh`` does on a host without 256 devices.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

from repro_torch.tree import tree_items, tree_rebuild

AX_DATA = ("pod", "data")  # batch / fsdp axis
AX_MODEL = "model"  # tensor-parallel axis


def _canonical(entry):
    """An entry as ``jax.sharding.PartitionSpec`` keeps it: a list is a
    tuple, a tuple of one axis that axis, an empty tuple ``None``."""
    if isinstance(entry, (list, tuple)):
        entry = tuple(entry)
        return None if not entry else (entry[0] if len(entry) == 1 else entry)
    return entry


class PartitionSpec:
    """Per-dimension sharding entries of one array: ``None`` (replicated),
    an axis name, or a tuple of axis names.  Iterates, indexes and
    compares as the tuple of its entries; the port's tree walks
    (``repro_torch.tree``) take it as a leaf, as ``jax.tree`` takes the
    reference's ``PartitionSpec``."""

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        self._entries = tuple(_canonical(e) for e in entries)

    def __iter__(self) -> Iterator:
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            return self._entries == other._entries
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self._entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{self._entries!r}"


P = PartitionSpec


class MeshLayout:
    """A device mesh as axis names and sizes; ``shape[axis]`` and
    ``axis_names`` read as on a ``jax.sharding.Mesh``."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...]):
        if len(shape) != len(axis_names):
            raise ValueError(f"{len(shape)} sizes for {len(axis_names)} axes")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, shape))

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    @property
    def name(self) -> str:
        """The reference dry run's label: ``16x16`` or ``pod2x16x16``."""
        sizes = "x".join(str(self.shape[a]) for a in self.axis_names if a != "pod")
        return f"pod{self.shape['pod']}x{sizes}" if "pod" in self.shape else sizes

    def __repr__(self) -> str:
        return f"MeshLayout({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> MeshLayout:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshLayout(shape, axes)


def one_device_mesh() -> MeshLayout:
    """The single-pod axes, each of size 1: the layout of one card."""
    return MeshLayout((1, 1), ("data", "model"))


def require_devices(mesh: MeshLayout, n_devices: int) -> None:
    """Raise unless ``mesh`` holds exactly the ``n_devices`` the port runs on."""
    if mesh.size != n_devices:
        raise RuntimeError(
            f"mesh {mesh.shape} needs {mesh.size} devices; the port runs on {n_devices}")


def _resolve_entry(entry, mesh_axes):
    if entry is None:
        return None
    if isinstance(entry, str):
        return entry if entry in mesh_axes else None
    # tuple of axes: keep only those present
    kept = tuple(a for a in entry if a in mesh_axes)
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


def resolve_spec(spec: P, mesh: MeshLayout) -> P:
    axes = set(mesh.axis_names)
    return P(*[_resolve_entry(e, axes) for e in spec])


def resolve_specs(tree: Any, mesh: MeshLayout) -> Any:
    return tree_rebuild(tree, lambda _, s: resolve_spec(s, mesh))


def named_shardings(tree: Any, mesh: MeshLayout) -> Any:
    """The reference's ``NamedSharding`` tree.  There is no device object
    to build here: each leaf is its spec resolved against ``mesh``."""
    return resolve_specs(tree, mesh)


def _axis_size(mesh: MeshLayout, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, str):
        return mesh.shape[entry]
    n = 1
    for a in entry:
        n *= mesh.shape[a]
    return n


def fit_spec(spec: P, shape: Tuple[int, ...], mesh: MeshLayout) -> P:
    """Resolve ``spec`` against ``mesh`` and drop axes (rightmost first
    within each dim) until every dim divides evenly — pjit requires exact
    divisibility of argument shardings."""
    resolved = resolve_spec(spec, mesh)
    out = []
    for d, entry in enumerate(resolved):
        if d >= len(shape):
            break
        if entry is None:
            out.append(None)
            continue
        axes = [entry] if isinstance(entry, str) else list(entry)
        while axes and shape[d] % _axis_size(mesh, tuple(axes)) != 0:
            axes.pop()
        out.append(None if not axes else (axes[0] if len(axes) == 1 else tuple(axes)))
    return P(*out)


def _leaves_by_key(tree: Any) -> Dict[str, Any]:
    return dict(tree_items(tree))


def fitted_shardings(spec_tree: Any, shape_tree: Any, mesh: MeshLayout) -> Any:
    """:func:`fit_spec` of every leaf against its array's shape: a spec
    tree keyed as ``spec_tree``, which must have ``shape_tree``'s keys."""
    shapes = _leaves_by_key(shape_tree)
    if set(shapes) != set(_leaves_by_key(spec_tree)):
        raise ValueError("the spec tree and the array tree have different keys")
    return tree_rebuild(spec_tree, lambda k, s: fit_spec(s, tuple(shapes[k].shape), mesh))


def shard_shape(shape: Tuple[int, ...], fitted: P, mesh: MeshLayout) -> Tuple[int, ...]:
    """The per-device shape of an array of ``shape`` under a fitted spec."""
    entries = tuple(fitted) + (None,) * (len(shape) - len(fitted))
    return tuple(d // _axis_size(mesh, e) for d, e in zip(shape, entries))


def per_device_bytes(spec_tree: Any, shape_tree: Any, mesh: MeshLayout) -> int:
    """Bytes one device holds of ``shape_tree``'s arrays (tensors, or
    anything with ``shape`` and ``dtype.itemsize``) under the fitted
    specs: the counterpart of ``memory_analysis().argument_size_in_bytes``
    for arguments sharded as the specs say."""
    fitted = _leaves_by_key(fitted_shardings(spec_tree, shape_tree, mesh))
    total = 0
    for k, arr in _leaves_by_key(shape_tree).items():
        n = 1
        for d in shard_shape(tuple(arr.shape), fitted[k], mesh):
            n *= d
        total += n * arr.dtype.itemsize
    return total
