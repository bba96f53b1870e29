"""Flat peer-stacked parameters and parameter-subset selection.

The port of :mod:`dpwa_tpu.utils.pytree`.  Where the reference keeps a
pytree of ``[n, ...]`` leaves and lets XLA fuse the exchange over them, the
port keeps every peer's parameters in ONE float32 buffer, so the whole
exchange is one kernel launch over ``[n, P]``:

- :class:`FlatParams` holds the buffer and hands out named ``[n, *shape]``
  views of it.  Leaves sit in the order ``jax.tree_util.tree_flatten`` gives
  the reference's params (keys sorted level by level), so column ranges
  correspond leaf for leaf — unless a ``first`` predicate places the
  leaves it selects (say the LoRA adapters) ahead of the rest, each group
  in that order, so that an exchange or an optimizer over them covers ONE
  column range.  Rows are padded to a multiple of :data:`ROW_ALIGN` floats
  (zeros that every elementwise pass keeps at zero) so that each row
  starts on a 128-byte boundary and the kernels can move 16-byte words.
- :func:`partition` / :func:`combine` split a ``{name: tensor}`` dict by a
  predicate on the name, as the reference does by key path.
- :func:`tree_wire_bytes` is the bytes one exchange ships.
- :meth:`FlatParams.leaf_ranges` gives the exchanged leaves one by one in
  the reference's flatten order; :meth:`FlatParams.wire_leaves` the same
  with each leaf's axis order to the reference's layout where the port
  keeps another (a ResNet's conv kernels OIHW against the reference's
  HWIO), for the int8 wire's chunks; :meth:`FlatParams.reference_order`
  the columns of a row in the order ``jax.flatten_util.ravel_pytree``
  reads the reference's tree, the TCP frame's order.
- :func:`stack_with_state` lays out parameters and model state (BatchNorm's
  running statistics) as two holders side by side in one buffer, the
  state's columns right after the parameters', and :func:`joint_flat`
  gives the ``[n, P + S]`` matrix over both, so that one merge launch
  exchanges both.

Names are the torch module's dotted parameter names (``BasicBlock_0.Conv_0.
kernel``); the reference's key path of the same leaf is ``params/`` plus
the name with ``/`` for ``.``.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as torch_pytree

from dpwa_tpu_torch.ops.quantize import CHUNK, leaf_columns, n_chunks

ROW_ALIGN = 32  # floats: 128 bytes


class Leaves(dict):
    """``{name: tensor}`` that knows its layout: :attr:`axes` maps a leaf's
    name to the axis order that gives it the reference's layout, for the
    leaves the port lays out otherwise (:func:`dpwa_tpu_torch.convert.
    reference_axes`).  The port's ResNet and ConvNet ``init`` return one;
    :class:`FlatParams` takes the axes from the tensors it is stacked from
    and gives them back with its :meth:`~FlatParams.leaves`, so the int8
    wire's chunks and the TCP frame find the reference's element order with
    no caller passing it on."""

    def __init__(self, tensors=(), axes: Mapping[str, Tuple[int, ...]] | None = None):
        super().__init__(tensors)
        self.axes = dict(axes or {})


# A node of torch's pytrees, so torch.func transforms and maps a Leaves as
# a dict and gives back one with the same axes.
torch_pytree.register_pytree_node(
    Leaves,
    lambda t: (list(t.values()), (list(t.keys()), t.axes)),
    lambda values, context: Leaves(zip(context[0], values), context[1]),
)


def layout_axes(tensors: Mapping) -> Dict[str, Tuple[int, ...]]:
    """The :attr:`Leaves.axes` of ``tensors`` (none for a plain dict)."""
    return dict(getattr(tensors, "axes", None) or {})

NamePredicate = Callable[[str], bool]


def leaf_order(names: Iterable[str]) -> list[str]:
    """``names`` in the reference's leaf order: sorted component by
    component, as ``jax.tree_util`` flattens nested dicts."""
    return sorted(names, key=lambda name: name.split("."))


def leaf_sizes(tensors: Mapping[str, torch.Tensor]) -> Tuple[int, ...]:
    """Per-leaf element counts in the reference's leaf order
    (:func:`leaf_order`), the sizes ``dpwa_tpu.utils.pytree.leaf_sizes``
    gives for the reference's tree: the leaves of the flat frame, in the
    order :meth:`FlatParams.reference_order` gathers them.  The trust
    screen's per-leaf statistic segments the frame by them."""
    return tuple(int(tensors[k].numel()) for k in leaf_order(tensors))


def padded_width(size: int) -> int:
    """``size`` floats rounded up to whole :data:`ROW_ALIGN` blocks (at least one)."""
    return -(-max(size, 1) // ROW_ALIGN) * ROW_ALIGN


class FlatParams:
    """Every peer's parameters in one ``[n, P]`` float32 buffer.

    ``flat`` is the ``[n, P]`` view the optimizer and the exchange work on
    (in a buffer :attr:`ld` ≥ P columns wide); :meth:`views` gives the
    named ``[n, *shape]`` views of it, always in leaf order.  ``first`` (a
    name predicate) places the leaves it selects in the leading columns.
    The buffer is updated in place.  It is a new zeroed ``[n, P]`` tensor
    padded to :data:`ROW_ALIGN` floats, or the given ``buffer`` (an
    ``[n, ≥ P]`` view with unit column stride, e.g. columns of a larger
    one).  ``axes`` maps a leaf's name to the axis order that gives it the
    reference's layout, for the leaves the port lays out otherwise.
    """

    def __init__(
        self,
        names: Sequence[str],
        shapes: Sequence[Tuple[int, ...]],
        n_peers: int,
        *,
        device=None,
        dtype: torch.dtype = torch.float32,
        first: NamePredicate | None = None,
        buffer: torch.Tensor | None = None,
        axes: Mapping[str, Tuple[int, ...]] | None = None,
    ):
        if list(names) != leaf_order(names):
            raise ValueError("names must be in leaf order (see leaf_order)")
        self.names = tuple(names)
        self.shapes = tuple(tuple(int(s) for s in shape) for shape in shapes)
        self.n_peers = int(n_peers)
        self.first = first
        self.axes = dict(axes or {})
        if not set(self.axes) <= set(self.names):
            unknown = sorted(set(self.axes) - set(self.names))
            raise ValueError(f"axes names leaves that are not here: {unknown}")
        sizes = [int(torch.Size(shape).numel()) for shape in self.shapes]
        # Column order: the ``first`` leaves, then the rest, each in leaf order.
        self.placed = sorted(
            range(len(self.names)),
            key=lambda i: first is None or not first(self.names[i]),
        )
        self.offsets = [(0, 0)] * len(self.names)
        start = 0
        for i in self.placed:
            self.offsets[i] = (start, start + sizes[i])
            start += sizes[i]
        self.size = start
        if buffer is None:
            self.ld = padded_width(start)
            buffer = torch.zeros(self.n_peers, self.ld, dtype=dtype, device=device)
        elif (
            buffer.dim() != 2 or buffer.shape[0] != self.n_peers or buffer.shape[1] < start
            or buffer.dtype != dtype or buffer.stride(1) != 1
        ):
            raise ValueError(
                f"buffer must be [{self.n_peers}, >= {start}] {dtype} with unit column "
                f"stride, got {tuple(buffer.shape)} {buffer.dtype}"
            )
        self.ld = buffer.shape[1]
        self.buffer = buffer
        self._spare: torch.Tensor | None = None

    @classmethod
    def stack(
        cls, tensors: Mapping[str, torch.Tensor], *, device=None,
        first: NamePredicate | None = None,
    ) -> "FlatParams":
        """A new holder filled from ``{name: [n, *shape]}`` tensors (copied),
        with their :attr:`Leaves.axes`."""
        names = leaf_order(tensors)
        lead = tensors[names[0]]
        flat = cls(
            names,
            [tuple(tensors[k].shape[1:]) for k in names],
            lead.shape[0],
            device=device if device is not None else lead.device,
            dtype=lead.dtype,
            first=first,
            axes=layout_axes(tensors),
        )
        for name, view in flat.views().items():
            view.copy_(tensors[name])
        return flat

    @property
    def flat(self) -> torch.Tensor:
        """The ``[n, P]`` parameter matrix (a view of the padded buffer)."""
        return self.buffer[:, : self.size]

    def spare_flat(self) -> torch.Tensor:
        """The ``[n, P]`` view of a second buffer laid out like this one
        (allocated at the first call), for an out-of-place pass over
        :attr:`flat` whose result :meth:`swap` then makes the parameters."""
        if self._spare is None:
            self._spare = torch.zeros_like(self.buffer)
        return self._spare[:, : self.size]

    def swap(self) -> None:
        """Exchange the parameter buffer and the spare one: what was written
        into :meth:`spare_flat` becomes :attr:`flat`, with no copy.  Views
        taken before the swap keep pointing at the old buffer."""
        if self._spare is None:
            raise RuntimeError("swap() before spare_flat()")
        self.buffer, self._spare = self._spare, self.buffer

    def views(self) -> Dict[str, torch.Tensor]:
        """``{name: [n, *shape]}`` views into the buffer, in leaf order."""
        return {
            name: self.buffer[:, lo:hi].view(self.n_peers, *shape)
            for name, shape, (lo, hi) in zip(self.names, self.shapes, self.offsets)
        }

    def leaves(self) -> Leaves:
        """:meth:`views` with this holder's :attr:`axes`, to stack anew."""
        return Leaves(self.views(), self.axes)

    def pack(
        self, tensors: Mapping[str, torch.Tensor], pred: NamePredicate | None = None
    ) -> torch.Tensor:
        """The leaves of ``{name: [n, *shape]}`` that ``pred`` selects (all
        when None) as one new ``[n, T]`` tensor, in column order: the
        layout of :meth:`add_` and of an optimizer over those leaves."""
        return torch.cat(
            [
                tensors[self.names[i]].reshape(self.n_peers, -1)
                for i in self.placed
                if pred is None or pred(self.names[i])
            ],
            dim=1,
        )

    def add_(self, packed: torch.Tensor, pred: NamePredicate | None = None) -> None:
        """Add a :meth:`pack`-laid-out ``[n, T]`` tensor (e.g. updates) to
        the leaves ``pred`` selects, in place; the other columns are not
        touched."""
        ranges = self.column_ranges(pred)
        width = sum(hi - lo for lo, hi in ranges)
        if packed.shape != (self.n_peers, width):
            raise ValueError(
                f"packed is {tuple(packed.shape)}, expected ({self.n_peers}, {width}) columns"
            )
        start = 0
        for lo, hi in ranges:
            self.buffer[:, lo:hi].add_(packed[:, start : start + hi - lo])
            start += hi - lo

    def leaf_ranges(self, pred: NamePredicate | None = None) -> list[Tuple[int, int]]:
        """Column ranges ``[lo, hi)`` of the leaves whose name matches
        ``pred`` (all when None), one per leaf in leaf order: the order in
        which the reference flattens the exchanged tree, whose indices key
        the int8 wire's draws."""
        return [
            self.offsets[i] for i, name in enumerate(self.names)
            if pred is None or pred(name)
        ]

    def wire_leaves(self, pred: NamePredicate | None = None) -> list[tuple]:
        """:meth:`leaf_ranges` as the wire ships the leaves
        (:func:`~dpwa_tpu_torch.ops.quantize.leaf_columns`): ``(lo, hi)``,
        or ``(lo, hi, shape, axes)`` for a leaf stored in ``shape`` that the
        reference lays out as its ``permute(axes)``."""
        return [
            (lo, hi) if name not in self.axes else (lo, hi, shape, tuple(self.axes[name]))
            for name, shape, (lo, hi) in zip(self.names, self.shapes, self.offsets)
            if pred is None or pred(name)
        ]

    def reference_order(self, pred: NamePredicate | None = None) -> np.ndarray:
        """The row's columns of the leaves ``pred`` selects (all when
        None) in the reference's order: leaf by leaf in its flatten order,
        each leaf's elements in its layout — the order in which
        ``ravel_pytree`` flattens the reference's tree, so ``row[order]``
        is the reference's flat vector and ``row[order] = v`` writes one
        back."""
        cols = [leaf_columns(leaf) for leaf in self.wire_leaves(pred)]
        return np.concatenate(cols) if cols else np.zeros(0, np.int64)

    def column_ranges(self, pred: NamePredicate | None = None) -> list[Tuple[int, int]]:
        """Column ranges ``[lo, hi)`` of the leaves whose name matches
        ``pred`` (all leaves when None), in column order, adjacent leaves
        merged."""
        ranges: list[Tuple[int, int]] = []
        for i in self.placed:
            name, (lo, hi) = self.names[i], self.offsets[i]
            if pred is not None and not pred(name):
                continue
            if ranges and ranges[-1][1] == lo:
                ranges[-1] = (ranges[-1][0], hi)
            else:
                ranges.append((lo, hi))
        return ranges


def stack_with_state(
    params: Mapping[str, torch.Tensor], state: Mapping[str, torch.Tensor], *,
    device=None, first: NamePredicate | None = None,
) -> Tuple[FlatParams, FlatParams]:
    """Parameters and model state (each ``{name: [n, *shape]}``, copied) as
    two :class:`FlatParams` over one new buffer: the parameters' ``P``
    columns (``first`` placing theirs as usual, their layouts from
    :attr:`Leaves.axes`), then right after them the state's ``S``, the row
    padded to :data:`ROW_ALIGN` floats once.
    :func:`joint_flat` gives the ``[n, P + S]`` matrix over both."""
    groups = []
    for tensors in (params, state):
        names = leaf_order(tensors)
        groups.append((names, [tuple(tensors[k].shape[1:]) for k in names]))
    lead = params[groups[0][0][0]]
    n, dtype = lead.shape[0], lead.dtype
    device = device if device is not None else lead.device
    sizes = [sum(int(torch.Size(s).numel()) for s in shapes) for _, shapes in groups]
    buffer = torch.zeros(n, padded_width(sum(sizes)), dtype=dtype, device=device)
    holders = (
        FlatParams(*groups[0], n, dtype=dtype, first=first, buffer=buffer[:, : sizes[0]],
                   axes=layout_axes(params)),
        FlatParams(*groups[1], n, dtype=dtype, buffer=buffer[:, sizes[0]:]),
    )
    for holder, tensors in zip(holders, (params, state)):
        for name, view in holder.views().items():
            view.copy_(tensors[name])
    return holders


def joint_flat(params: FlatParams, state: FlatParams) -> torch.Tensor:
    """The ``[n, P + S]`` matrix over ``params``' columns and ``state``'s
    right after them, as :func:`stack_with_state` lays them out; raises if
    the two do not sit so."""
    a, b = params.buffer, state.buffer
    if not (
        a.device == b.device
        and a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()
        and b.storage_offset() == a.storage_offset() + params.ld
        and a.stride() == b.stride()
        and a.stride(0) >= params.ld + state.size
    ):
        raise ValueError("model state must sit right after the parameters in one "
                         "buffer (build the state with init_stacked_state)")
    return a.as_strided((params.n_peers, params.ld + state.size), a.stride())


def partition(
    tree: Mapping[str, torch.Tensor], pred: NamePredicate
) -> Tuple[Dict[str, torch.Tensor | None], Dict[str, torch.Tensor | None]]:
    """Split ``{name: tensor}`` into (selected, rest) by name predicate.
    Both keep every name; non-matching entries are None in ``selected`` and
    vice versa, so :func:`combine` zips them back together losslessly."""
    selected, rest = {}, {}
    for name, leaf in tree.items():
        hit = pred(name)
        selected[name] = leaf if hit else None
        rest[name] = None if hit else leaf
    return selected, rest


def combine(
    selected: Mapping[str, torch.Tensor | None],
    rest: Mapping[str, torch.Tensor | None],
) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`partition`: overlay two complementary dicts."""
    if selected.keys() != rest.keys():
        raise ValueError("partition trees are not complementary")
    merged = {}
    for name in selected:
        a, b = selected[name], rest[name]
        if (a is None) == (b is None):
            raise ValueError("partition trees are not complementary")
        merged[name] = a if a is not None else b
    return merged


def tree_wire_bytes(tree: Mapping[str, torch.Tensor], wire_dtype: str = "f32") -> int:
    """Per-exchange bytes one replica ships at a wire format, as the
    reference counts them by default (``padded=True``, the stacked and ICI
    transports' figure): float32 leaves at 2 bytes per element on the bf16
    wire; on the int8 wire each float32 leaf padded on its own to whole
    chunks, 1 byte per element plus one float32 scale per chunk; every
    other leaf as it is."""
    if wire_dtype not in ("f32", "bf16", "int8"):
        raise ValueError(f"unknown wire_dtype {wire_dtype!r}")
    total = 0
    for leaf in tree.values():
        if wire_dtype == "f32" or leaf.dtype != torch.float32:
            total += leaf.numel() * leaf.element_size()
        elif wire_dtype == "bf16":
            total += leaf.numel() * 2
        else:
            total += (CHUNK + 4) * n_chunks(leaf.numel())
    return total
