"""What the checkpoint files record about a tensor: the port of
``paddle_tpu/distributed/checkpoint/metadata.py``.

**Dtypes.** A tensor is stored as an ``.npy`` file and its dtype by name
in the metadata (``"float32"``, ``"int32"``, ``"bfloat16"``, ...). numpy
has no bf16 or fp8 (the card's machine has no ``ml_dtypes``), so those
are stored as integer views of the same width and turned back with
``.view`` on load, never through f32: the files are the JAX package's.

**Where a rank's tensor sits in the global tensor.** The JAX package reads
it from an array's ``NamedSharding``. A port tensor is a plain
``torch.Tensor`` holding this rank's part, so its place is a
:class:`Layout`, carried as the tensor's ``dist_layout`` attribute:

- a tensor-parallel parameter (``parallel_layers``, ``split_dims``):
  ``split = (dim, index, parts)`` from the rank's coordinate in the
  ``model`` group; an expert bank (``MoELayer`` under ep > 1): ``split =
  (0, index, ep)`` from its coordinate in the ``expert`` group, with
  ``axes=("expert",)``;
- a ZeRO stage-3 slice (``fleet.sharding.GroupShardedStage3``,
  ``zero3_shape``): ``flat = (lo, hi, shape)``, the range ``[lo, hi)`` of
  the row-major flattening of its (tensor-parallel) parameter of
  ``shape``; what lies past the parameter's end is padding, no part of
  the tensor;
- an optimizer slot or master weight: its parameter's layout
  (``Optimizer.state_dict``); a ZeRO stage-1/2 owner's state also varies
  along ``sharding``;
- a tensor without one: replicated, the whole tensor on every rank.

``axes`` names the fleet axes along which the rank's part differs; the
ranks that agree with this one on them hold the same part
(:func:`replica_index`), and under the pipeline only those of the same
stage. No layout names ``sep``: context parallelism splits the sequence,
not the weights, so the ranks of a ``sep`` group are replicas of every
tensor (and of the data ranks' parts), each writing its share of the
boxes once, and a checkpoint crosses sep degrees as it crosses data
degrees. :func:`boxes` maps a tensor to its global shape
and the boxes it covers (a flat range is at most ``2 * ndim - 1`` boxes:
a partial row, whole rows, a partial row, recursively);
:func:`placement_of` writes the JAX descriptor (the hybrid topology's
mesh in fleet's axis order and the split axis of each dim).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = ["NONNATIVE_DTYPES", "dtype_name", "to_numpy", "from_numpy",
           "Layout", "layout_of", "with_layout", "flat_boxes", "boxes",
           "local_part", "placement_of", "replica_index", "spanning_hcg"]

#: dtype names numpy's npy format cannot round-trip natively
NONNATIVE_DTYPES = ("bfloat16", "float8_e4m3fn", "float8_e5m2")


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"`` (numpy's name where numpy has
    the type)."""
    return str(dtype).removeprefix("torch.")


def to_numpy(t: torch.Tensor):
    """``(array, dtype name)`` of a tensor, on the host: bf16 and fp8 as
    uint16/uint8 views."""
    t = t.detach().cpu().contiguous()
    name = dtype_name(t.dtype)
    if name in NONNATIVE_DTYPES:
        t = t.view(torch.uint16 if t.element_size() == 2 else torch.uint8)
    return t.numpy(), name


def from_numpy(arr: np.ndarray, name: str) -> torch.Tensor:
    """The inverse of :func:`to_numpy`: a CPU tensor of dtype ``name``."""
    # ascontiguousarray makes a 0-d array 1-d
    t = torch.from_numpy(np.ascontiguousarray(arr)).reshape(arr.shape)
    if name in NONNATIVE_DTYPES:
        t = t.view(getattr(torch, name))
    return t


@dataclasses.dataclass(frozen=True)
class Layout:
    """This rank's part of a global tensor (module docstring)."""
    split: tuple | None = None      # (dim, index, parts)
    flat: tuple | None = None       # (lo, hi, shape)
    axes: tuple = ()                # fleet axes the part varies along

    @property
    def split_axis(self) -> str:
        """The fleet axis ``split`` runs over: ``expert`` for an expert
        bank, else ``model``."""
        return "expert" if "expert" in self.axes else "model"

    def varying(self, *axes) -> "Layout":
        """The same part, varying along ``axes`` too."""
        return dataclasses.replace(
            self, axes=tuple(dict.fromkeys(self.axes + tuple(axes))))


def layout_of(t) -> Layout | None:
    return getattr(t, "dist_layout", None)


def with_layout(t, layout):
    """``t`` with ``layout`` attached (None leaves it as it is)."""
    if layout is not None:
        t.dist_layout = layout
    return t


def flat_boxes(shape, lo, hi):
    """``[(offset, local_shape)]`` of the boxes that tile the range
    ``[lo, hi)`` of a row-major tensor of ``shape``, in order; each box is
    a contiguous range of the flattening."""
    shape = tuple(int(s) for s in shape)
    if hi <= lo:
        return []
    if not shape:
        return [((), ())]
    inner = math.prod(shape[1:])
    r0, c0 = divmod(lo, inner)
    r1, c1 = divmod(hi, inner)

    def row(r, a, b):
        return [((r,) + o, (1,) + s) for o, s in flat_boxes(shape[1:], a, b)]

    if c0 and r0 == r1:
        return row(r0, c0, c1)
    out = []
    if c0:
        out += row(r0, c0, inner)
        r0 += 1
    if r1 > r0:
        out.append(((r0,) + (0,) * (len(shape) - 1),
                    (r1 - r0,) + shape[1:]))
    if c1:
        out += row(r1, 0, c1)
    return out


def boxes(t, layout=None):
    """``(global_shape, [(offset, local_shape, view)])`` of this rank's
    tensor ``t`` under ``layout`` (its own by default): each view is the
    part of ``t`` that fills the box at ``offset`` of the global tensor."""
    lay = layout or layout_of(t) or Layout()
    if lay.flat is None:
        base = tuple(t.shape)
        parts = [((0,) * t.dim(), base, t)]
    else:
        lo, hi, base = lay.flat
        base = tuple(base)
        flat = t.reshape(-1)
        strides = [math.prod(base[d + 1:]) for d in range(len(base))]
        parts = []
        for off, shp in flat_boxes(base, lo, min(hi, math.prod(base))):
            a = sum(o * s for o, s in zip(off, strides)) - lo
            parts.append((off, shp, flat[a:a + math.prod(shp)].view(shp)))
    gshape = list(base)
    if lay.split is not None:
        dim, index, n = lay.split
        gshape[dim] *= n
        shift = index * base[dim]
        parts = [(tuple(o + shift if d == dim else o
                        for d, o in enumerate(off)), shp, v)
                 for off, shp, v in parts]
    return tuple(gshape), parts


def local_part(full, layout):
    """This rank's tensor under ``layout`` cut from the full tensor
    ``full`` (a stage-3 slice zero-padded past the parameter's end)."""
    if layout is None:
        return full
    t = full
    if layout.split is not None:
        dim, index, n = layout.split
        t = t.chunk(n, dim=dim)[index]
    if layout.flat is not None:
        lo, hi, _ = layout.flat
        flat = t.reshape(-1)
        out = flat.new_zeros(hi - lo)
        end = min(hi, flat.numel())
        if end > lo:
            out[:end - lo] = flat[lo:end]
        t = out
    return t


def spanning_hcg():
    """The initialised fleet's topology when it spans more than one
    rank, else None."""
    from ..fleet.base import current_hcg
    hcg = current_hcg()
    if hcg is None or hcg.topology().world_size() <= 1:
        return None
    return hcg


def placement_of(t):
    """The JAX package's placement descriptor of this rank's tensor ``t``
    under the initialised fleet: ``mesh_shape``/``mesh_axes`` of the
    hybrid topology in fleet's axis order and ``spec`` naming the split
    axis of each dim (``"model"``, ``"expert"`` for an expert bank, or
    None); a stage-3 slice adds
    ``"flat": "sharding"``. None without a fleet of more than one rank
    (what a single-device JAX array records)."""
    hcg = spanning_hcg()
    if hcg is None:
        return None
    topo = hcg.topology()
    names = list(topo.get_hybrid_group_names())
    lay = layout_of(t) or Layout()
    ndim = len(lay.flat[2]) if lay.flat is not None else t.dim()
    spec = [None] * ndim
    if lay.split is not None:
        spec[lay.split[0]] = lay.split_axis
    desc = {"mesh_shape": [int(topo.get_dim(n)) for n in names],
            "mesh_axes": names, "spec": spec}
    if lay.flat is not None:
        desc["flat"] = "sharding"
    return desc


def replica_index(layout, rank, world, hcg=None):
    """``(index, count)``: this rank's place among the ``count`` ranks
    that hold the same part as it does under ``layout``: under a fleet,
    the ranks agreeing with it on the layout's axes, and on the ``pipe``
    axis when it has more than one stage (a stage's tensors are its own,
    whatever their layout: a tensor more than one stage holds, such as a
    shared weight, is written by each, the copies alike; the ``data``,
    ``sep`` and ``sharding`` ranks of a replicated part are its holders);
    without one, every rank for a replicated tensor and this rank alone
    for any other."""
    axes = layout.axes if layout is not None else ()
    if hcg is None:
        return (0, 1) if axes else (rank, world)
    if hcg.get_pipe_parallel_world_size() > 1 and "pipe" not in axes:
        axes = axes + ("pipe",)
    topo = hcg.topology()
    me = topo.get_coord(rank)
    holders = [r for r in range(topo.world_size())
               if all(topo.get_coord(r)[a] == me[a] for a in axes)]
    return holders.index(rank), len(holders)
