"""The port's grouped-matmul kernels (paddle_tpu_torch.ops.kernels.
grouped_matmul) against the JAX package's Pallas kernels, on the CPU.

K14 in both modes (``grouped_matmul``, ``grouped_matmul_t``) and K15
(``grouped_dw``): the port's plain versions, which CPU tensors take,
against the Pallas kernels run in interpret mode, as
``tests/test_moe_grouped.py`` runs them, on the group-padded layout of
``sort_rows_by_expert`` with uneven groups and an expert without rows;
and ``GroupedMatmulFunction``'s gradients against ``jax.grad`` of the
``custom_vjp``. Inputs come from numpy seeds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import moe as jmoe
from paddle_tpu.ops.pallas import grouped_matmul as jgmm

from paddle_tpu_torch.ops.kernels import grouped_matmul as kgmm

torch.set_num_threads(1)

E, T, K_TOP, D, H = 5, 37, 2, 48, 40
EMPTY = 2          # an expert that no token picks (not the last one)


def _layout(bm, seed):
    """Uneven groups from a seeded routing where expert EMPTY gets no
    rows; returns (gate_idx, tile_gid, P, the real rows) from the JAX
    package."""
    rng = np.random.RandomState(seed)
    choices = np.array([e for e in range(E) if e != EMPTY])
    # skewed: expert 0 takes about half the assignments
    p = np.array([0.5, 0.1, 0.25, 0.15])
    gate_idx = rng.choice(choices, (T, K_TOP), p=p).astype(np.int32)
    perm, tile_gid, P = jmoe.sort_rows_by_expert(jnp.asarray(gate_idx), E,
                                                 bm=bm)
    return gate_idx, np.array(tile_gid), P, np.asarray(perm)


def _inputs(P, real, dtype, seed, d=D, h=H):
    """x with zero padding rows (the layout's contract), w and dy."""
    rng = np.random.RandomState(seed)
    x = np.zeros((P, d), np.float32)
    x[real] = rng.randn(len(real), d)
    w = rng.randn(E, d, h).astype(np.float32)
    dy = rng.randn(P, h).astype(np.float32)
    jt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx, jw, jdy = (jnp.asarray(a, jt) for a in (x, w, dy))
    tx, tw, tdy = (torch.from_numpy(a).to(dtype) for a in (x, w, dy))
    return (jx, jw, jdy), (tx, tw, tdy)


def _exact(tx, tw, tdy, tile_gid, bm):
    """f64 products of the (rounded) inputs: y, dx, dw and the sums of
    |terms| that bound each one's rounding error."""
    x, w, dy = (t.double().numpy() for t in (tx, tw, tdy))
    row_e = np.repeat(tile_gid, bm)
    wr = w[row_e]                                    # [P, D, H], tiny here
    y = np.einsum("pd,pdh->ph", x, wr)
    ya = np.einsum("pd,pdh->ph", np.abs(x), np.abs(wr))
    dx = np.einsum("ph,pdh->pd", dy, wr)
    dxa = np.einsum("ph,pdh->pd", np.abs(dy), np.abs(wr))
    dw = np.zeros((E, x.shape[1], dy.shape[1]))
    dwa = np.zeros_like(dw)
    for p in range(x.shape[0]):
        dw[row_e[p]] += np.outer(x[p], dy[p])
        dwa[row_e[p]] += np.outer(np.abs(x[p]), np.abs(dy[p]))
    return (y, ya), (dx, dxa), (dw, dwa)


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _check(name, out, exact, mag, dtype):
    """Per element. f32: summation order only, 1e-6 of the sum of
    |terms|. bf16: the products are exact in f32 and both sides sum in
    f32 and round once: within one ulp (2^-7 relative) of the exact sum,
    plus the f32 summation noise."""
    out = np.asarray(out, np.float64)
    tol = 1e-6 * mag + 1e-12
    if dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * np.abs(exact)
    err = np.abs(out - exact)
    assert (err <= tol).all(), (name, float((err / tol).max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "bm,d,h", [(8, D, H), (128, D, H),
               # contractions that are not multiples of the card kernel's
               # 64-wide step (72 = 64 + 8, 136 = 128 + 8), outputs past
               # its 128-wide tiles
               (128, 72, 136)],
    ids=["8", "128", "128-d72-h136"])
def test_grouped_kernels_match_pallas(dtype, bm, d, h):
    gate_idx, tile_gid, P, real = _layout(bm, seed=bm)
    assert EMPTY not in gate_idx and EMPTY in tile_gid
    (jx, jw, jdy), (tx, tw, tdy) = _inputs(P, real, dtype, seed=3, d=d,
                                           h=h)
    jgid, tgid = jnp.asarray(tile_gid), torch.from_numpy(tile_gid)
    (y, ya), (dx, dxa), (dw, dwa) = _exact(tx, tw, tdy, tile_gid, bm)

    wrappers = (kgmm.grouped_matmul, kgmm.grouped_matmul_t, kgmm.grouped_dw)
    before = [f.launches for f in wrappers]
    ty = kgmm.grouped_matmul(tx, tw, tgid)
    jy = jgmm._gmm_call(jx, jw, jgid, transpose_rhs=False, bn=h)
    tdx = kgmm.grouped_matmul_t(tdy, tw, tgid)
    jdx = jgmm.grouped_matmul_t(jdy, jw, jgid, bn=d)
    tdw = kgmm.grouped_dw(tx, tdy, tgid, E)
    jdw = jgmm.grouped_dw(jx, jdy, jgid, E, bd=d, bh=h)
    assert ty.dtype == tdx.dtype == tdw.dtype == dtype
    assert tdw.shape == (E, d, h)
    for name, t, j, (ex, mag) in (("y", ty, jy, (y, ya)),
                                  ("dx", tdx, jdx, (dx, dxa)),
                                  ("dw", tdw, jdw, (dw, dwa))):
        _check(f"port {name}", t.float().numpy(), ex, mag, dtype)
        _check(f"pallas {name}", _np(j), ex, mag, dtype)
    # the expert without rows: a zero block on both sides
    assert not tdw[EMPTY].any() and not _np(jdw)[EMPTY].any()
    # the CPU path runs no kernel
    assert [f.launches for f in wrappers] == before


def test_grouped_matmul_function_grads_match_the_custom_vjp():
    bm = 8
    _, tile_gid, P, real = _layout(bm, seed=11)
    (jx, jw, jdy), (tx, tw, tdy) = _inputs(P, real, torch.float32, seed=4)
    jgid = jnp.asarray(tile_gid)

    def loss(x, w):
        return jnp.sum(jgmm.grouped_matmul(x, w, jgid, bn=H, bd=D, bh=H)
                       * jdy)

    jgx, jgw = jax.grad(loss, argnums=(0, 1))(jx, jw)
    tx.requires_grad_()
    tw.requires_grad_()
    y = kgmm.GroupedMatmulFunction.apply(tx, tw, torch.from_numpy(tile_gid))
    (y * tdy).sum().backward()
    # f32, summation order only
    np.testing.assert_allclose(tx.grad.numpy(), _np(jgx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), _np(jgw), rtol=1e-5,
                               atol=1e-4)
    assert tw.grad.dtype == tw.dtype


def test_wrappers_on_a_device_without_kernels_raise():
    """Only a CPU tensor takes the plain version; any other device
    launches the kernel or raises: nothing falls back."""
    x = torch.empty(128, 8, device="meta")
    w = torch.empty(2, 8, 8, device="meta")
    gid = torch.empty(1, dtype=torch.int32, device="meta")
    for call in (lambda: kgmm.grouped_matmul(x, w, gid),
                 lambda: kgmm.grouped_matmul_t(x, w, gid),
                 lambda: kgmm.grouped_dw(x, x, gid, 2)):
        with pytest.raises(RuntimeError, match="no kernel for device"):
            call()
