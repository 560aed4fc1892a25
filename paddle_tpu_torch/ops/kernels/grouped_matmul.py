"""Grouped matmul for the dropless MoE: the CUDA kernels
``csrc/grouped_matmul.cu`` and their plain PyTorch versions, with the
autograd function that joins them.

Port of ``paddle_tpu/ops/pallas/grouped_matmul.py``: ``_fwd_kernel``
through ``_gmm_call`` in both modes (K14: :func:`grouped_matmul`, and
:func:`grouped_matmul_t` with ``transpose_rhs``), ``_dw_kernel`` through
``_dw_call`` (K15: :func:`grouped_dw`) and the ``custom_vjp`` of
``_gmm_core`` (:class:`GroupedMatmulFunction`). The tuner surface
(``_tile_config``, the registered tile grid, ``grouped_matmul_cost``) is
not ported: the kernels choose their own tiles.

Layout contract (built by ``ops.moe.sort_rows_by_expert``): x [P, d]
holds the routed rows sorted by expert and group-padded, so that each
tile of ``bm = P // len(tile_gid)`` rows belongs to the one expert that
``tile_gid`` [P // bm] (int32, non-decreasing) names, and every expert
owns a contiguous run of tiles; w is [E, d, h]. Products are f32 and each
output is rounded once to x's dtype.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["grouped_matmul", "grouped_matmul_reference", "grouped_matmul_t",
           "grouped_dw", "grouped_dw_reference", "GroupedMatmulFunction"]


def _runs(tile_gid: torch.Tensor, bm: int):
    """(expert, first row, last row + 1) of each run of equal ids."""
    ids, counts = torch.unique_consecutive(tile_gid, return_counts=True)
    start = 0
    for e, c in zip(ids.tolist(), counts.tolist()):
        yield e, start * bm, (start + c) * bm
        start += c


def grouped_matmul_reference(x: torch.Tensor, w: torch.Tensor,
                             tile_gid: torch.Tensor,
                             transpose_rhs: bool = False) -> torch.Tensor:
    """Plain version of K14: ``x[t] @ w[gid]`` (``@ w[gid].T`` when
    ``transpose_rhs``), one f32 product per expert over its run of row
    tiles, rounded once to x's dtype. ``w`` is never gathered per tile."""
    P = x.shape[0]
    bm = P // tile_gid.shape[0]
    out_dim = w.shape[1] if transpose_rhs else w.shape[2]
    y = torch.empty(P, out_dim, dtype=x.dtype, device=x.device)
    for e, lo, hi in _runs(tile_gid, bm):
        we = w[e].float()
        y[lo:hi] = (x[lo:hi].float() @ (we.t() if transpose_rhs else we)).to(
            x.dtype)
    return y


def grouped_dw_reference(x: torch.Tensor, dy: torch.Tensor,
                         tile_gid: torch.Tensor,
                         n_experts: int) -> torch.Tensor:
    """Plain version of K15: ``dw[e] = x[group e].T @ dy[group e]`` [E, d,
    h], f32 and rounded once to x's dtype; an expert without tiles gets
    zeros."""
    bm = x.shape[0] // tile_gid.shape[0]
    dw = torch.zeros(n_experts, x.shape[1], dy.shape[1], dtype=torch.float32,
                     device=x.device)
    for e, lo, hi in _runs(tile_gid, bm):
        dw[e] += x[lo:hi].float().t() @ dy[lo:hi].float()
    return dw.to(x.dtype)


def _check(name, x, w, tile_gid, w_rank, k_dim, out_dim):
    """Device, rank, dtype, layout and width checks of x [P, k_dim] and the
    second operand w (rank ``w_rank``); returns bm."""
    if x.device.type != "cuda":
        raise _build.KernelError(f"{name}: no kernel for device {x.device}")
    if x.dim() != 2 or w.dim() != w_rank:
        raise ValueError(f"{name}: x {tuple(x.shape)}, second operand "
                         f"{tuple(w.shape)}: wrong ranks")
    if w.dtype != x.dtype or w.device != x.device:
        raise ValueError(f"{name}: {w.dtype} on {w.device} does not match "
                         f"x {x.dtype} on {x.device}")
    if (tile_gid.dtype != torch.int32 or tile_gid.dim() != 1
            or tile_gid.device != x.device):
        raise ValueError(f"{name}: tile_gid must be a 1-D int32 tensor on "
                         f"{x.device}, not {tile_gid.dtype} "
                         f"{tuple(tile_gid.shape)} on {tile_gid.device}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (x, w, tile_gid)):
        raise ValueError(f"{name}: the kernel takes contiguous, 16-byte "
                         f"aligned tensors")
    P, nr = x.shape[0], tile_gid.shape[0]
    if nr == 0 or P % nr:
        raise ValueError(f"{name}: {P} rows are not {nr} tiles")
    bm = P // nr
    if bm % 128:
        raise ValueError(f"{name}: the kernel takes row tiles of a multiple "
                         f"of 128 rows, not bm = {bm}")
    if k_dim % 8 or out_dim % 8:
        raise ValueError(f"{name}: widths {k_dim} and {out_dim} must be "
                         f"multiples of 8 (16-byte rows)")
    return bm


def _gmm(name, x, w, tile_gid, transpose_rhs):
    if x.device.type == "cpu":
        return grouped_matmul_reference(x, w, tile_gid, transpose_rhs)
    k_dim = x.shape[1]
    out_dim = w.shape[1] if transpose_rhs else w.shape[2]
    want = w.shape[2] if transpose_rhs else w.shape[1]
    bm = _check(name, x, w, tile_gid, 3, k_dim, out_dim)
    if want != k_dim:
        raise ValueError(f"{name}: x [P, {k_dim}] does not contract with w "
                         f"{tuple(w.shape)}")
    code = _build.dtype_code(x.dtype)
    lib = _build.build()
    y = torch.empty(x.shape[0], out_dim, dtype=x.dtype, device=x.device)
    rc = lib.grouped_matmul_fwd(x.data_ptr(), w.data_ptr(),
                                tile_gid.data_ptr(), y.data_ptr(),
                                w.shape[0], x.shape[0], k_dim, out_dim, bm,
                                int(transpose_rhs), code,
                                _build.stream_ptr(x.device))
    _build.check(rc, name)
    return y


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   tile_gid: torch.Tensor) -> torch.Tensor:
    """K14: ``y[t] = x[t] @ w[gid(t // bm)]`` -> [P, h]. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel or raises."""
    y = _gmm("grouped_matmul", x, w, tile_gid, False)
    if x.device.type != "cpu":
        grouped_matmul.launches += 1
    return y


def grouped_matmul_t(dy: torch.Tensor, w: torch.Tensor,
                     tile_gid: torch.Tensor) -> torch.Tensor:
    """K14 transposed (dx of the grouped matmul): ``dy[t] @ w[gid].T`` ->
    [P, d]. A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel or raises."""
    y = _gmm("grouped_matmul_t", dy, w, tile_gid, True)
    if dy.device.type != "cpu":
        grouped_matmul_t.launches += 1
    return y


def grouped_dw(x: torch.Tensor, dy: torch.Tensor, tile_gid: torch.Tensor,
               n_experts: int) -> torch.Tensor:
    """K15: ``dw[e] = x[group e].T @ dy[group e]`` -> [E, d, h] in x's
    dtype, zeros for an expert without rows. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    if x.device.type == "cpu":
        return grouped_dw_reference(x, dy, tile_gid, n_experts)
    bm = _check("grouped_dw", x, dy, tile_gid, 2, x.shape[1], dy.shape[1])
    if dy.shape[0] != x.shape[0]:
        raise ValueError(f"grouped_dw: x {tuple(x.shape)} and dy "
                         f"{tuple(dy.shape)} differ in rows")
    code = _build.dtype_code(x.dtype)
    lib = _build.build()
    d, h = x.shape[1], dy.shape[1]
    dw = torch.empty(n_experts, d, h, dtype=x.dtype, device=x.device)
    rc = lib.grouped_matmul_dw(x.data_ptr(), dy.data_ptr(),
                               tile_gid.data_ptr(), dw.data_ptr(), d, h,
                               int(n_experts), tile_gid.shape[0], bm, code,
                               _build.stream_ptr(x.device))
    _build.check(rc, "grouped_dw")
    grouped_dw.launches += 1
    return dw


#: kernel launches since the last reset (chip_smoke.py reads and zeroes them)
grouped_matmul.launches = 0
grouped_matmul_t.launches = 0
grouped_dw.launches = 0


class GroupedMatmulFunction(torch.autograd.Function):
    """``grouped_matmul(x, w, tile_gid)`` with the backward of the JAX
    ``custom_vjp``: dx by :func:`grouped_matmul_t`, dw by
    :func:`grouped_dw` cast to w's dtype; tile_gid (routing data) gets no
    gradient."""

    @staticmethod
    def forward(ctx, x, w, tile_gid):
        ctx.save_for_backward(x, w, tile_gid)
        return grouped_matmul(x, w, tile_gid)

    @staticmethod
    def backward(ctx, dy):
        x, w, tile_gid = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = grouped_matmul_t(dy, w, tile_gid)
        if ctx.needs_input_grad[1]:
            dw = grouped_dw(x, dy, tile_gid, w.shape[0]).to(w.dtype)
        return dx, dw, None
