"""The collective API: the port of
``paddle_tpu/distributed/communication.py`` over ``torch.distributed``.

The JAX package lowers collectives to XLA ops over mesh axes inside
compiled code, and runs them host-mediated between processes in eager
mode. The port runs one process per rank, as Paddle does, and every
collective here is an eager ``torch.distributed`` call on the rank's own
tensors. JAX's traced-axis helpers (``in_traced_collective``,
``axis_in_traced_region``) have no counterpart: there is no traced
region, and the parallel layers call these functions directly inside
their autograd functions.

A :class:`Group` wraps a ``ProcessGroup`` and its global ranks; ``rank``
is this process's index in it (-1 outside). With one participant (no
process group, world size 1, or a group of one) every op is the identity,
as the JAX package's eager mode is.

**The backend rule** (``env.backend_rule``, printed by ``fleet.init``):
under ``gloo`` a collective over CUDA tensors copies them to host
buffers, runs the gloo op and copies the result back. Ops gloo lacks are
built from ops it has: ``reduce_scatter`` is an ``all_reduce`` and the
rank's slice, ``alltoall`` an ``isend``/``irecv`` pair with each other
member (:func:`_pair_exchange`: only the parts a rank needs, their bytes
as they are), ``alltoall_single`` an ``all_gather`` and the rank's
column, ``AVG`` a ``SUM`` divided by the group's size. This path is for
correctness when ranks share one card, not for speed; two rules halve
the bytes of bf16/f16 tensors, which gloo would carry widened to f32:
``broadcast`` moves their bytes as they are, and a ``SUM``/``AVG`` over
a group of two swaps the two tensors' bytes and adds them in f32 on
each rank (:func:`_pair_reduce`, the bits of the widened sum). Under
``nccl`` every op is the native one on the device.
"""

from __future__ import annotations

import torch
import torch.distributed as torch_dist

__all__ = ["ReduceOp", "Group", "new_group", "get_group", "all_reduce",
           "all_gather", "all_gather_object", "reduce_scatter", "alltoall",
           "alltoall_single", "broadcast", "broadcast_object_list", "reduce",
           "scatter", "send", "recv", "isend", "irecv", "barrier", "wait",
           "P2POp", "batch_isend_irecv", "stream", "gather",
           "scatter_object_list", "destroy_process_group", "get_backend",
           "is_available"]


#: float dtypes a gloo buffer widens to f32
_LOW = (torch.bfloat16, torch.float16)


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


def _torch_op(op):
    r = torch_dist.ReduceOp
    return {ReduceOp.SUM: r.SUM, ReduceOp.MAX: r.MAX, ReduceOp.MIN: r.MIN,
            ReduceOp.PROD: r.PRODUCT, ReduceOp.AVG: r.AVG}[op]


class Group:
    """Global ``ranks`` (sorted) and their ``ProcessGroup`` (None for a
    group of one, or before any process group exists)."""

    def __init__(self, gid, ranks, pg=None, axis_name=None, backend=None):
        self.id = gid
        self.ranks = list(ranks)
        self.process_group = pg
        self.axis_name = axis_name
        self.backend = backend

    @property
    def nranks(self):
        return len(self.ranks)

    world_size = nranks

    @property
    def rank(self):
        from .env import get_rank
        me = get_rank()
        return self.ranks.index(me) if me in self.ranks else -1

    def is_member(self):
        return self.rank >= 0

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    def __repr__(self):
        return (f"Group(id={self.id}, ranks={self.ranks}, "
                f"axis={self.axis_name!r}, backend={self.backend!r})")


_groups: dict[int, Group] = {}
_next_gid = [1]


def _dist():
    """``torch.distributed`` once a process group exists, else None."""
    return torch_dist if torch_dist.is_available() and \
        torch_dist.is_initialized() else None


def _default_group() -> Group:
    g = _groups.get(0)
    dist = _dist()
    n = dist.get_world_size() if dist is not None else 1
    if g is None or g.nranks != n:
        from .env import _State
        g = Group(0, range(n), None, None, _State.backend)
        _groups[0] = g
    return g


def new_group(ranks=None, backend=None, timeout=None, axis_name=None):
    """A group over the global ``ranks`` (all when None). Every process
    must call it, members or not, in the same order, as
    ``torch.distributed.new_group`` requires. A group of one makes no
    process group."""
    dist = _dist()
    world = dist.get_world_size() if dist is not None else 1
    ranks = sorted(range(world) if ranks is None else ranks)
    if any(r < 0 or r >= world for r in ranks):
        raise ValueError(f"new_group: ranks {ranks} outside the world of "
                         f"{world}")
    from .env import _State
    backend = backend or _State.backend
    pg = None
    if dist is not None and len(ranks) > 1:
        kw = {}
        if timeout is not None:
            from datetime import timedelta
            kw["timeout"] = timedelta(seconds=float(timeout))
        pg = dist.new_group(ranks, backend=backend, **kw)
        if pg is dist.GroupMember.NON_GROUP_MEMBER:
            pg = None
    gid = _next_gid[0]
    _next_gid[0] += 1
    g = Group(gid, ranks, pg, axis_name, backend)
    _groups[gid] = g
    return g


def get_group(gid: int = 0) -> Group:
    return _groups[gid] if gid in _groups else _default_group()


def _resolve(group):
    return _default_group() if group is None else group


def _active(g) -> bool:
    """True when ``g`` has more than one participant and this rank is
    one of them; a non-member must not call into the group."""
    if g.nranks <= 1:
        return False
    if _dist() is None:
        return False
    if not g.is_member():
        raise RuntimeError(f"rank {_dist().get_rank()} is not a member of "
                           f"{g}")
    return True


def _pg(g):
    return g.process_group    # None: the default (world) group


def _staged(g, t) -> bool:
    """The backend rule: gloo over a CUDA tensor stages through host."""
    return (g.backend or "gloo") == "gloo" and t.is_cuda


def _host(g, t):
    """The buffer a gloo op runs on: a contiguous host copy of a CUDA
    tensor, the (contiguous) tensor itself otherwise; a bf16/f16 tensor
    is widened to f32 there (gloo's sums then round once, on the way
    back)."""
    low = t.dtype in _LOW and (g.backend or "gloo") == "gloo"
    if _staged(g, t) or low:
        return t.detach().to("cpu" if t.is_cuda else t.device,
                             torch.float32 if low else t.dtype, copy=True)
    return t if t.is_contiguous() else t.contiguous()


def _back(t, buf):
    if buf is not t:
        t.copy_(buf)
    return t


def _bytes_of(t):
    """A low-precision tensor's bytes as a flat uint8 host buffer (a
    copy when ``t`` is on the card or not contiguous)."""
    flat = t.detach().reshape(-1).view(torch.uint8)
    return flat.cpu() if flat.is_cuda else flat.contiguous()


#: elements a step of :func:`_pair_reduce`'s f32 sum (its temporaries)
_PAIR_STEP = 1 << 24


def _pair_reduce(g, tensor, avg):
    """``SUM`` (``AVG`` with ``avg``) of a bf16/f16 tensor over a gloo
    group of two: the ranks all-gather the tensor's bytes (half the bytes
    gloo's sum of the f32-widened tensors moves) and each adds its own
    and the other's in f32 on the tensor's device, halves it for the
    mean and rounds once. A sum of two f32 terms is the same either way
    round, so every rank gets the widened path's bits."""
    dist = _dist()
    mine = _bytes_of(tensor)
    both = [torch.empty_like(mine) for _ in range(2)]
    dist.all_gather(both, mine, group=_pg(g))
    other = both[1 - g.rank].to(tensor.device).view(tensor.dtype)
    out = tensor.detach().reshape(-1)
    if not out.is_contiguous() or out.data_ptr() != tensor.data_ptr():
        out = out.clone()
    for at in range(0, out.numel(), _PAIR_STEP):
        part = out[at:at + _PAIR_STEP]
        total = part.float() + other[at:at + _PAIR_STEP].float()
        if avg:
            total.div_(2)
        part.copy_(total)
    if out.data_ptr() != tensor.data_ptr():
        tensor.copy_(out.view_as(tensor))
    return tensor


def _pair_exchange(g, parts):
    """gloo's all-to-all: part ``j`` to member ``j`` and member ``j``'s
    part for this rank back, each by one ``isend``/``irecv`` pair of the
    parts' bytes (nothing is summed, so nothing is widened; a rank moves
    only the parts others need). Returns the received parts in group
    order, on the parts' device."""
    dist = _dist()
    mine = [_bytes_of(t.contiguous()) for t in parts]
    got, works = list(mine), []
    for j, peer in enumerate(g.ranks):
        if j == g.rank:
            continue
        got[j] = torch.empty_like(mine[j])
        works.append(dist.isend(mine[j], dst=peer, group=_pg(g)))
        works.append(dist.irecv(got[j], src=peer, group=_pg(g)))
    for w in works:
        w.wait()
    t = parts[g.rank]
    return [parts[j] if j == g.rank else
            got[j].to(t.device).view(t.dtype).view(t.shape)
            for j in range(g.nranks)]


class _Work:
    """A finished (or staged) op's handle: ``wait`` waits for the torch
    work, then copies a staged receive back onto its device."""

    def __init__(self, work=None, after=None):
        self._work, self._after = work, after

    def wait(self):
        if self._work is not None:
            self._work.wait()
            self._work = None
        if self._after is not None:
            self._after()
            self._after = None
        return True

    def is_completed(self):
        return self._work is None or self._work.is_completed()


def _done(sync_op):
    """A blocking op returns None, an asynchronous one a finished work."""
    return None if sync_op else _Work()


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    g = _resolve(group)
    if not _active(g):
        return _done(sync_op)
    dist = _dist()
    gloo = (g.backend or "gloo") == "gloo"
    if (gloo and g.nranks == 2 and tensor.dtype in _LOW
            and op in (ReduceOp.SUM, ReduceOp.AVG)):
        with torch.no_grad():
            _pair_reduce(g, tensor, op == ReduceOp.AVG)
        return _done(sync_op)
    buf = _host(g, tensor)
    if op == ReduceOp.AVG and gloo:
        dist.all_reduce(buf, dist.ReduceOp.SUM, group=_pg(g))
        buf.div_(g.nranks)
    else:
        dist.all_reduce(buf, _torch_op(op), group=_pg(g))
    _back(tensor, buf)
    return _done(sync_op)


def all_gather(tensor_list, tensor, group=None, sync_op=True, axis=0):
    """Every member's ``tensor`` (same shape), in group order, appended to
    ``tensor_list`` (returned)."""
    if tensor_list is None:
        tensor_list = []
    g = _resolve(group)
    if not _active(g):
        tensor_list.append(tensor)
        return tensor_list
    dist = _dist()
    buf = _host(g, tensor)
    outs = [buf.new_empty(buf.shape) for _ in range(g.nranks)]
    dist.all_gather(outs, buf, group=_pg(g))
    tensor_list.extend(o.to(tensor.device, tensor.dtype) for o in outs)
    return tensor_list


def all_gather_object(object_list, obj, group=None):
    g = _resolve(group)
    if not _active(g):
        object_list.append(obj)
        return object_list
    out = [None] * g.nranks
    _dist().all_gather_object(out, obj, group=_pg(g))
    object_list.extend(out)
    return object_list


def reduce_scatter(tensor, tensor_list=None, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """``tensor`` becomes the reduction over the members of their
    ``tensor_list[rank]`` (a list of one tensor a member, or one tensor
    split evenly along dim 0)."""
    g = _resolve(group)
    parts = list(tensor_list) if isinstance(tensor_list, (list, tuple)) \
        else list(torch.chunk(tensor_list, max(g.nranks, 1), dim=0))
    if not _active(g):
        with torch.no_grad():
            tensor.copy_(parts[0].reshape(tensor.shape))
        return _done(sync_op)
    dist = _dist()
    if (g.backend or "gloo") == "gloo":
        whole = torch.cat([p.reshape(-1) for p in parts])
        all_reduce(whole, op, g)
        n = parts[g.rank].numel()
        with torch.no_grad():
            tensor.copy_(whole[g.rank * n:(g.rank + 1) * n]
                         .reshape(tensor.shape))
        return _done(sync_op)
    bufs = [p.contiguous() for p in parts]
    dist.reduce_scatter(tensor, bufs, op=_torch_op(op), group=_pg(g))
    return _done(sync_op)


def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """Member ``j`` receives every member's ``in_tensor_list[j]``, in
    group order (all of one shape)."""
    if out_tensor_list is None:
        out_tensor_list = []
    g = _resolve(group)
    if not _active(g):
        out_tensor_list.extend(in_tensor_list)
        return out_tensor_list
    dist = _dist()
    if (g.backend or "gloo") == "gloo":
        out_tensor_list.extend(_pair_exchange(g, list(in_tensor_list)))
        return out_tensor_list
    outs = [torch.empty_like(t) for t in in_tensor_list]
    dist.all_to_all(outs, [t.contiguous() for t in in_tensor_list],
                    group=_pg(g))
    out_tensor_list.extend(outs)
    return out_tensor_list


def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """``in_tensor``'s rows split by ``in_split_sizes`` (even without
    them) go one part to each member; ``out_tensor`` receives the parts
    sent to this rank, in group order."""
    g = _resolve(group)
    if not _active(g):
        with torch.no_grad():
            out_tensor.copy_(in_tensor)
        return _done(sync_op)
    n = g.nranks
    dist = _dist()
    if (g.backend or "gloo") == "gloo":
        if in_split_sizes is None:
            if in_tensor.shape[0] % n:
                raise ValueError(f"alltoall_single: dim 0 "
                                 f"({in_tensor.shape[0]}) is not divisible "
                                 f"by the group's {n} members")
            in_split_sizes = [in_tensor.shape[0] // n] * n
        splits = []
        all_gather_object(splits, list(map(int, in_split_sizes)), g)
        lens = []
        all_gather_object(lens, int(in_tensor.shape[0]), g)
        longest = max(lens)
        pad = in_tensor.new_zeros((longest,) + tuple(in_tensor.shape[1:]))
        pad[:in_tensor.shape[0]] = in_tensor
        rows = all_gather([], pad, g)
        parts = []
        for src in range(n):
            start = sum(splits[src][:g.rank])
            parts.append(rows[src][start:start + splits[src][g.rank]])
        with torch.no_grad():
            out_tensor.copy_(torch.cat(parts))
        return _done(sync_op)
    dist.all_to_all_single(out_tensor, in_tensor.contiguous(),
                           out_split_sizes, in_split_sizes, group=_pg(g))
    return _done(sync_op)


def broadcast(tensor, src=0, group=None, sync_op=True):
    """``tensor`` takes global rank ``src``'s value on every member."""
    g = _resolve(group)
    if not _active(g):
        return _done(sync_op)
    if tensor.dtype in _LOW and (g.backend or "gloo") == "gloo":
        # no arithmetic: the bytes as they are, not widened
        buf = _bytes_of(tensor)
        _dist().broadcast(buf, src=src, group=_pg(g))
        with torch.no_grad():
            tensor.copy_(buf.to(tensor.device).view(tensor.dtype)
                         .view(tensor.shape))
        return _done(sync_op)
    buf = _host(g, tensor)
    _dist().broadcast(buf, src=src, group=_pg(g))
    _back(tensor, buf)
    return _done(sync_op)


def broadcast_object_list(object_list, src=0, group=None):
    g = _resolve(group)
    if not _active(g):
        return object_list
    _dist().broadcast_object_list(object_list, src=src, group=_pg(g))
    return object_list


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """The reduction lands on global rank ``dst``; the others' tensors
    are left as they are."""
    g = _resolve(group)
    if not _active(g):
        return _done(sync_op)
    dist = _dist()
    # a copy: the op may leave partial sums in the others' buffers
    buf = _host(g, tensor)
    if buf is tensor:
        buf = tensor.clone()
    if op == ReduceOp.AVG and (g.backend or "gloo") == "gloo":
        dist.reduce(buf, dst, dist.ReduceOp.SUM, group=_pg(g))
        if dist.get_rank() == dst:
            buf.div_(g.nranks)
    else:
        dist.reduce(buf, dst, _torch_op(op), group=_pg(g))
    if dist.get_rank() == dst:
        tensor.copy_(buf)
    return _done(sync_op)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """``tensor`` takes ``tensor_list[rank]`` of global rank ``src``."""
    g = _resolve(group)
    if not _active(g):
        with torch.no_grad():
            tensor.copy_(tensor_list[0])
        return _done(sync_op)
    dist = _dist()
    buf = _host(g, tensor)
    parts = None
    if dist.get_rank() == src:
        parts = [_host(g, t) for t in tensor_list]
    dist.scatter(buf, parts, src=src, group=_pg(g))
    _back(tensor, buf)
    return _done(sync_op)


def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True):
    """Every member's ``tensor`` onto global rank ``dst``'s
    ``gather_list`` (in group order); the others' lists stay as they
    are. (Inside the JAX package's traced regions it is an all-gather.)"""
    if gather_list is None:
        gather_list = []
    g = _resolve(group)
    if not _active(g):
        gather_list.append(tensor)
        return gather_list
    dist = _dist()
    buf = _host(g, tensor)
    outs = [buf.new_empty(buf.shape) for _ in range(g.nranks)] \
        if dist.get_rank() == dst else None
    dist.gather(buf, outs, dst=dst, group=_pg(g))
    if outs is not None:
        gather_list.extend(o.to(tensor.device, tensor.dtype) for o in outs)
    return gather_list


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    g = _resolve(group)
    if not _active(g):
        out_object_list[:] = [in_object_list[0]] if in_object_list else []
        return out_object_list
    out = [None]
    dist = _dist()
    dist.scatter_object_list(out, in_object_list if dist.get_rank() == src
                             else None, src=src, group=_pg(g))
    out_object_list[:] = out
    return out_object_list


# ---- point to point -------------------------------------------------------

_p2p_buf: list = []     # a one-rank send parks here for its recv


def send(tensor, dst=0, group=None, sync_op=True):
    g = _resolve(group)
    if not _active(g):
        _p2p_buf.append(tensor)
        return _done(sync_op)
    _dist().send(_host(g, tensor), dst=dst, group=_pg(g))
    return _done(sync_op)


def recv(tensor, src=0, group=None, sync_op=True):
    g = _resolve(group)
    if not _active(g):
        if _p2p_buf:
            with torch.no_grad():
                tensor.copy_(_p2p_buf.pop(0))
        return _done(sync_op)
    buf = _host(g, tensor)
    _dist().recv(buf, src=src, group=_pg(g))
    _back(tensor, buf)
    return _done(sync_op)


def isend(tensor, dst=0, group=None):
    g = _resolve(group)
    if not _active(g):
        _p2p_buf.append(tensor)
        return _Work()
    buf = _host(g, tensor)
    work = _dist().isend(buf, dst=dst, group=_pg(g))
    return _Work(work, after=lambda: buf)     # keeps the host copy alive


def irecv(tensor, src=0, group=None):
    g = _resolve(group)
    if not _active(g):
        recv(tensor, src, g)
        return _Work()
    buf = _host(g, tensor)
    work = _dist().irecv(buf, src=src, group=_pg(g))
    return _Work(work, after=lambda: _back(tensor, buf))


class P2POp:
    def __init__(self, op, tensor, peer, group=None):
        if op not in (isend, irecv):
            raise ValueError("P2POp: op must be distributed.isend or "
                             "distributed.irecv")
        self.op, self.tensor, self.peer, self.group = op, tensor, peer, group


def batch_isend_irecv(p2p_op_list):
    """Start every op of the list; returns their works (``wait`` each)."""
    return [op.op(op.tensor, op.peer, op.group) for op in p2p_op_list]


def barrier(group=None):
    g = _resolve(group)
    if _active(g):
        _dist().barrier(group=_pg(g))


def wait(tensor, group=None, use_calc_stream=True):
    """Wait until ``tensor``'s pending work on its device is done."""
    if tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()
    return tensor


class stream:
    """``paddle.distributed.stream``: the stream-targeted variants. Every
    op here runs on the current stream; these alias the defaults."""

    all_reduce = staticmethod(all_reduce)
    all_gather = staticmethod(all_gather)
    reduce_scatter = staticmethod(reduce_scatter)
    alltoall = staticmethod(alltoall)
    alltoall_single = staticmethod(alltoall_single)
    broadcast = staticmethod(broadcast)
    reduce = staticmethod(reduce)
    scatter = staticmethod(scatter)
    gather = staticmethod(gather)
    send = staticmethod(send)
    recv = staticmethod(recv)


def destroy_process_group(group=None):
    """With no group: leave the job (the process group, the environment,
    ``fleet``'s topology and every group); else drop ``group``."""
    dist = _dist()
    if group is not None:
        if dist is not None and group.process_group is not None:
            dist.destroy_process_group(group.process_group)
        _groups.pop(group.id, None)
        return
    if dist is not None:
        dist.destroy_process_group()
    _groups.clear()
    _next_gid[0] = 1
    from . import env
    env._reset()
    import sys
    base = sys.modules.get(__package__ + ".fleet.base")
    if base is not None:
        base.fleet._reset()


def get_backend(group=None) -> str:
    """The backend of ``group`` (the world's by default): ``nccl`` or
    ``gloo`` by the rule of ``env.backend_rule``."""
    if group is not None and group.backend:
        return group.backend
    from .env import _State
    return _State.backend or "gloo"


def is_available() -> bool:
    return torch_dist.is_available()
