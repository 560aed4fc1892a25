"""The hybrid topology: the port of
``paddle_tpu/distributed/fleet/topology.py``.

``CommunicateTopology`` is the JAX package's rank and coordinate
arithmetic, unchanged. ``HybridCommunicateGroup`` builds, where the JAX
package names mesh axes, one process group per axis: for each axis of
more than one rank, every list of ranks that differ only along it becomes
a group (``communication.new_group``, called by every rank in the same
order), and this rank keeps the one it belongs to. Axes are taken in the
JAX order ``("data", "sharding", "pipe", "sep", "model", "expert")``.
With ``sep`` above 1 the ranks that differ only along ``data`` and
``sep`` make one more group (``get_dp_sep_parallel_group``, Paddle's
name): the parameters are replicated over both, so their gradients are
averaged over it.
"""

from __future__ import annotations

import numpy as np

from ..communication import Group, new_group

__all__ = ["CommunicateTopology", "HybridCommunicateGroup"]


class CommunicateTopology:
    def __init__(self, hybrid_group_names=("data", "pipe", "sharding",
                                           "sep", "model", "expert"),
                 dims=(1, 1, 1, 1, 1, 1)):
        self._names = list(hybrid_group_names)
        self._dims = list(dims)
        self._world = int(np.prod(self._dims))
        self._rank_arr = np.arange(self._world).reshape(self._dims)

    def get_hybrid_group_names(self):
        return self._names

    def get_dim(self, axis_name):
        return self._dims[self._names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world

    def get_rank(self, **kwargs):
        idx = tuple(kwargs[n] for n in self._names)
        return int(self._rank_arr[idx])

    def get_coord(self, rank):
        coords = np.unravel_index(rank, self._dims)
        return {n: int(c) for n, c in zip(self._names, coords)}

    def get_axis_list(self, axis_name, index):
        """All ranks whose `axis_name` coordinate == index."""
        ax = self._names.index(axis_name)
        sl = [slice(None)] * len(self._dims)
        sl[ax] = index
        return self._rank_arr[tuple(sl)].reshape(-1).tolist()

    def get_comm_list(self, axis_name):
        """List of rank-groups along `axis_name` (one per other-coord)."""
        ax = self._names.index(axis_name)
        moved = np.moveaxis(self._rank_arr, ax, -1)
        return moved.reshape(-1, self._dims[ax]).tolist()

    def get_fused_comm_list(self, axis_names):
        """The rank-groups whose ranks differ only along ``axis_names``
        (one per coordinate of the other axes), each in rank order."""
        axes = [self._names.index(a) for a in axis_names]
        moved = np.moveaxis(self._rank_arr, axes,
                            range(-len(axes), 0))
        size = int(np.prod([self._dims[a] for a in axes]))
        return [sorted(g) for g in moved.reshape(-1, size).tolist()]


class HybridCommunicateGroup:
    """This rank's coordinates in ``topology`` and its group along each
    axis (a group of one where the axis has one rank)."""

    def __init__(self, topology: CommunicateTopology, global_rank=None):
        from ..env import get_rank
        self._topo = topology
        self.global_rank = get_rank() if global_rank is None \
            else global_rank
        self.nranks = topology.world_size()
        coord = topology.get_coord(self.global_rank)
        self._dp_rank = coord.get("data", 0)
        self._sharding_rank = coord.get("sharding", 0)
        self._pp_rank = coord.get("pipe", 0)
        self._mp_rank = coord.get("model", 0)
        self._sep_rank = coord.get("sep", 0)
        self._ep_rank = coord.get("expert", 0)
        self.dp_axis_name = "data"
        self.sharding_axis_name = "sharding"
        self.pp_axis_name = "pipe"
        self.mp_axis_name = "model"
        self.sep_axis_name = "sep"
        self.ep_axis_name = "expert"
        self._groups = {}
        for name in topology.get_hybrid_group_names():
            mine = None
            if topology.get_dim(name) > 1:
                # every rank makes every group of the axis, in one order
                for ranks in topology.get_comm_list(name):
                    g = new_group(ranks, axis_name=name)
                    if self.global_rank in ranks:
                        mine = g
            else:
                mine = Group(-1, [self.global_rank], None, name)
            self._groups[name] = mine
        self._dp_sep = self._groups.get("data")
        names = topology.get_hybrid_group_names()
        if "data" in names and "sep" in names and \
                topology.get_dim("sep") > 1:
            if topology.get_dim("data") == 1:
                self._dp_sep = self._groups["sep"]
            else:
                for ranks in topology.get_fused_comm_list(("data", "sep")):
                    g = new_group(ranks, axis_name="data_sep")
                    if self.global_rank in ranks:
                        self._dp_sep = g

    def topology(self):
        return self._topo

    def get_parallel_mode(self):
        if self.get_model_parallel_world_size() > 1 or \
                self.get_pipe_parallel_world_size() > 1:
            return "hybrid"
        if self.get_sharding_parallel_world_size() > 1:
            return "sharding"
        if self.get_data_parallel_world_size() > 1:
            return "data"
        return "single"

    def _src(self, name):
        return self._groups[name].ranks[0]

    # data parallel
    def get_data_parallel_rank(self):
        return self._dp_rank

    def get_data_parallel_world_size(self):
        return self._topo.get_dim("data")

    def get_data_parallel_group(self) -> Group:
        return self._groups["data"]

    def get_data_parallel_group_src_rank(self):
        return self._src("data")

    # model (tensor) parallel
    def get_model_parallel_rank(self):
        return self._mp_rank

    def get_model_parallel_world_size(self):
        return self._topo.get_dim("model")

    def get_model_parallel_group(self) -> Group:
        return self._groups["model"]

    def get_model_parallel_group_src_rank(self):
        return self._src("model")

    # pipeline
    def get_stage_id(self):
        return self._pp_rank

    def get_pipe_parallel_rank(self):
        return self._pp_rank

    def get_pipe_parallel_world_size(self):
        return self._topo.get_dim("pipe")

    def get_pipe_parallel_group(self) -> Group:
        return self._groups["pipe"]

    def is_first_stage(self):
        return self._pp_rank == 0

    def is_last_stage(self):
        return self._pp_rank == self.get_pipe_parallel_world_size() - 1

    # sharding
    def get_sharding_parallel_rank(self):
        return self._sharding_rank

    def get_sharding_parallel_world_size(self):
        return self._topo.get_dim("sharding")

    def get_sharding_parallel_group(self) -> Group:
        return self._groups["sharding"]

    def get_sharding_parallel_group_src_rank(self):
        return self._src("sharding")

    # sep (sequence/context)
    def get_sep_parallel_rank(self):
        return self._sep_rank

    def get_sep_parallel_world_size(self):
        return self._topo.get_dim("sep")

    def get_sep_parallel_group(self) -> Group:
        return self._groups["sep"]

    def get_dp_sep_parallel_group(self) -> Group:
        """The ranks that differ only along ``data`` and ``sep`` (the
        ``data`` group at sep degree 1)."""
        return self._dp_sep

    def get_dp_sep_parallel_world_size(self):
        return self._dp_sep.nranks

    # expert parallel
    def get_expert_parallel_rank(self):
        return self._ep_rank

    def get_expert_parallel_world_size(self):
        try:
            return self._topo.get_dim("expert")
        except ValueError:
            return 1

    def get_expert_parallel_group(self) -> Group:
        return self._groups.get("expert")

    def get_check_parallel_group(self, *a):
        return self._groups["model"]

    def get_rank_from_stage(self, stage_id, **kwargs):
        coord = self._topo.get_coord(self.global_rank)
        coord["pipe"] = stage_id
        coord.update(kwargs)
        return self._topo.get_rank(**coord)
