"""Context parallelism of the port at the op level
(``ops.ring_attention``'s ring, Ulysses and all-gather attention over a
``sep`` group, ``fleet.meta_parallel.context_parallel``'s wrappers) over
2, 4 and 8 gloo ranks on the CPU, against the JAX package. The models
under ``sep_parallel`` and pp x sep are in
``tests/test_torch_context_parallel_{models,qwen2,pipe}.py``.

The same q, k, v (numpy from a seed) go through the JAX functions under
``shard_map`` over the conftest's CPU devices, at every degree
``tests/test_context_parallel.py`` uses, and through the port on that
many ranks (``torch_dist_pool.RankPool`` running ``torch_cp_cases``),
each rank on its contiguous slice of the sequence; the slices are put
back together here.

Tolerances: f32 outputs ``rtol=atol=2e-5`` and gradients ``rtol=atol=
1e-4`` (the JAX tests' own against dense attention); bf16 outputs
``rtol=atol=1e-2`` (about one bf16 rounding of a value near 1; the JAX
test's is 3e-2 against dense).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

try:
    from jax import shard_map
except ImportError:                                  # jax <= 0.4.x
    from jax.experimental.shard_map import shard_map

import paddle_tpu as paddle
from paddle_tpu.distributed.fleet.meta_parallel import context_parallel \
    as jcp
from paddle_tpu.ops import ring_attention as jra
from paddle_tpu.ops.pallas.flash_attention import flash_attention_reference

from paddle_tpu_torch.distributed.fleet.meta_parallel import context_parallel \
    as tcp
from paddle_tpu_torch.ops import ring_attention as tra

from torch_dist_pool import RankPool

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pools():
    """One pool alive at a time (the tests are ordered by world size)."""
    made = {}

    def get(n):
        if n not in made or not made[n].alive():
            for m in [m for m in made if m != n]:
                made.pop(m).close()
            made[n] = RankPool(n)
        return made[n]

    yield get
    for pool in made.values():
        pool.close()


# ---- the ops: the JAX side -----------------------------------------------------

def _mk_qkv(b=2, s=64, h=4, hkv=None, d=8, seed=0):
    rng = np.random.RandomState(seed)
    hkv = hkv or h
    return (rng.randn(b, s, h, d).astype(np.float32),
            rng.randn(b, s, hkv, d).astype(np.float32),
            rng.randn(b, s, hkv, d).astype(np.float32))


def _jax_core(impl, n, causal, placement="contiguous"):
    if impl == "ring":
        return lambda a, b, c: jra.ring_attention(
            a, b, c, "sep", causal=causal, placement=placement)
    if impl == "ulysses":
        return lambda a, b, c: jra.ulysses_attention(a, b, c, "sep",
                                                     causal=causal)
    return lambda a, b, c: jra.allgather_attention(a, b, c, "sep",
                                                   causal=causal)


def _jax_sharded(impl, n, causal, placement="contiguous"):
    mesh = Mesh(np.array(jax.devices()[:n]), ("sep",))
    spec = P(None, "sep", None, None)
    return shard_map(_jax_core(impl, n, causal, placement), mesh=mesh,
                     in_specs=(spec, spec, spec), out_specs=spec)


def _jax_out(impl, n, q, k, v, causal, placement="contiguous",
             dtype=jnp.float32):
    f = jax.jit(_jax_sharded(impl, n, causal, placement))
    return np.asarray(f(*(jnp.asarray(a).astype(dtype) for a in (q, k, v))),
                      np.float32)


def _jax_grads(impl, n, q, k, v, causal):
    f = _jax_sharded(impl, n, causal)

    def loss(a, b, c):
        out = f(a, b, c)
        return jnp.sum(out * jnp.cos(out))

    out = np.asarray(jax.jit(f)(q, k, v))
    g = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return out, [np.asarray(x) for x in g]


# ---- the ops: the port's side, every case of a degree in one call --------------

def _cases(n):
    """The op cases at degree ``n``: (name, impl, q, k, v, causal,
    placement, dtype, grads)."""
    base = _mk_qkv()
    out = []
    for causal in (False, True):
        for impl in ("ring", "allgather") + (("ulysses",) if n <= 4 else ()):
            qkv = _mk_qkv(h=8) if impl == "ulysses" else base
            out.append((f"{impl}_{causal}", impl, *qkv, causal, "contiguous",
                        "float32", False))
    if n == 4:
        gqa = _mk_qkv(h=8, hkv=2)
        out.append(("ring_gqa", "ring", *gqa, True, "contiguous", "float32",
                    False))
        zz = [tra.zigzag_reorder(a, n, axis=1) for a in base]
        out.append(("ring_zigzag", "ring", *zz, True, "zigzag", "float32",
                    False))
        small = _mk_qkv(s=32, h=2, d=4)
        for causal in (False, True):
            out.append((f"ring_grad_{causal}", "ring", *small, causal,
                        "contiguous", "float32", True))
        gqa32 = _mk_qkv(h=8, hkv=2, s=32)
        for impl in ("ulysses", "allgather"):
            out.append((f"{impl}_gqa_grad", impl, *gqa32, True,
                        "contiguous", "float32", True))
        out.append(("ring_bf16", "ring", *base, True, "contiguous",
                    "bfloat16", False))
        out.append(("ulysses_refused", "ulysses", *_mk_qkv(h=6), True,
                    "contiguous", "float32", False))
    if n == 8:
        out.append(("ulysses_refused", "ulysses", *base, True, "contiguous",
                    "float32", False))
    return out


_PORT = {}


def port_ops(pools, n):
    if n not in _PORT:
        got = pools(n).run("torch_cp_cases:op_cases", _cases(n))
        merged = {}
        for name in got[0]:
            if isinstance(got[0][name][0], str):       # an error
                merged[name] = got[0][name]
                continue
            parts = [g[name] for g in got]
            merged[name] = (np.concatenate([p[0] for p in parts], axis=1),
                            parts[0][1],
                            *[np.concatenate([p[i] for p in parts], axis=1)
                              for i in range(2, len(parts[0]))])
        _PORT[n] = merged
    return _PORT[n]


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# ---- the ops, degree 2 then 4 then 8 -----------------------------------------------

@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl", ["ring", "allgather", "ulysses"])
def test_forward_matches_the_jax_function(pools, impl, causal, n):
    """Each implementation's output at degree 2, 4 and 8 (Ulysses at 2
    and 4: 8 ranks do not divide its heads) against the JAX function
    under ``shard_map``, causal or not."""
    if impl == "ulysses" and n == 8:
        got = port_ops(pools, n)["ulysses_refused"]
        assert got[:2] == ("error", "ValueError") and "divisible" in got[2]
        return
    q, k, v = _mk_qkv(h=8) if impl == "ulysses" else _mk_qkv()
    want = _jax_out(impl, n, q, k, v, causal)
    _close(port_ops(pools, n)[f"{impl}_{causal}"][0], want, 2e-5)


def test_ring_gqa_and_zigzag(pools):
    """Degree 4: the ring over 8 query heads and 2 kv heads (the compact
    heads travel, repeated after each shift), and the zigzag placement
    (reordered here, restored after), against the JAX ring and the dense
    reference."""
    got = port_ops(pools, 4)
    q, k, v = _mk_qkv(h=8, hkv=2)
    _close(got["ring_gqa"][0], _jax_out("ring", 4, q, k, v, True), 2e-5)
    q, k, v = _mk_qkv()
    zz = [jra.zigzag_reorder(jnp.asarray(a), 4, axis=1) for a in (q, k, v)]
    want = np.asarray(jra.zigzag_restore(
        jnp.asarray(_jax_out("ring", 4, *zz, True, "zigzag")), 4, axis=1))
    out = tra.zigzag_restore(got["ring_zigzag"][0], 4, axis=1)
    _close(out, want, 2e-5)
    _close(out, np.asarray(flash_attention_reference(
        *(jnp.asarray(a) for a in (q, k, v)), causal=True)), 2e-5)


@pytest.mark.parametrize("name,impl,shape,causal", [
    ("ring_grad_False", "ring", dict(s=32, h=2, d=4), False),
    ("ring_grad_True", "ring", dict(s=32, h=2, d=4), True),
    ("ulysses_gqa_grad", "ulysses", dict(h=8, hkv=2, s=32), True),
    ("allgather_gqa_grad", "allgather", dict(h=8, hkv=2, s=32), True)])
def test_gradients_match_the_jax_function(pools, name, impl, shape, causal):
    """dq, dk and dv of ``sum(out * cos(out))`` through each
    implementation's backward (the reverse ring, the reverse all-to-all,
    the all-gather's reduce-scatter) at degree 4, against ``jax.grad``
    of the JAX function under ``shard_map``."""
    q, k, v = _mk_qkv(**shape)
    out, grads = _jax_grads(impl, 4, q, k, v, causal)
    got = port_ops(pools, 4)[name]
    _close(got[0], out, 2e-5)
    for a, b in zip(got[2:], grads):
        _close(a, b, 1e-4)


def test_ring_bf16(pools):
    """bf16 q, k, v: the ring keeps f32 partials and returns bf16, as the
    JAX ring does."""
    got = port_ops(pools, 4)["ring_bf16"]
    assert got[1] == "torch.bfloat16"
    q, k, v = _mk_qkv()
    _close(got[0], _jax_out("ring", 4, q, k, v, True, dtype=jnp.bfloat16),
           1e-2)


def test_ulysses_refuses_a_degree_that_does_not_divide_the_heads(pools):
    """6 heads over 4 ranks (and 4 over 8) raise ``ValueError``, as the JAX
    function does."""
    got = port_ops(pools, 4)["ulysses_refused"]
    assert got[:2] == ("error", "ValueError")
    assert "num_heads (6) divisible by the sep degree (4)" in got[2]
    with pytest.raises(ValueError, match="divisible"):
        mesh = Mesh(np.array(jax.devices()[:4]), ("sep",))
        spec = P(None, "sep", None, None)
        q, k, v = _mk_qkv(h=6)
        shard_map(_jax_core("ulysses", 4, True), mesh=mesh,
                  in_specs=(spec, spec, spec), out_specs=spec)(q, k, v)


def test_zigzag_helpers_and_positions_equal_the_jax_ones():
    """``zigzag_reorder``/``zigzag_restore`` (tensors and arrays),
    ``zigzag_positions``, ``sep_positions`` and ``split_inputs_sequence_
    dim`` against the JAX package's, the round trip exact."""
    x = np.arange(48.0).reshape(1, 48, 1)
    for n in (1, 2, 4):
        want = np.asarray(jra.zigzag_reorder(jnp.asarray(x), n))
        np.testing.assert_array_equal(tra.zigzag_reorder(x, n), want)
        np.testing.assert_array_equal(
            tra.zigzag_reorder(torch.from_numpy(x), n).numpy(), want)
        np.testing.assert_array_equal(
            tra.zigzag_restore(tra.zigzag_reorder(x, n), n), x)
        np.testing.assert_array_equal(tra.zigzag_positions(48, n),
                                      jra.zigzag_positions(48, n))
        np.testing.assert_array_equal(
            tcp.sep_positions(48, degree=n, zigzag=True),
            jcp.sep_positions(48, degree=n, zigzag=True))
    ids = np.arange(32).reshape(1, 32).astype(np.int64)
    for zig in (False, True):
        for r in range(4):
            want = jcp.split_inputs_sequence_dim(
                paddle.to_tensor(ids), rank=r, degree=4, zigzag=zig)
            got = tcp.split_inputs_sequence_dim(torch.from_numpy(ids),
                                                rank=r, degree=4, zigzag=zig)
            np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(ValueError, match="not divisible"):
        tcp.split_inputs_sequence_dim(ids[:, :30], rank=0, degree=4)


def test_fleet_wrappers_at_degree_2_and_1(pools):
    """The fleet wrappers over a sep group of 2: ``ring_flash_attention``
    and ``ulysses_attention`` and ``sep_attention`` of each impl equal the
    JAX wrappers' full attention (degree 1) on the whole sequence, and
    ``sep_attention_manual`` the JAX rope at the global positions before
    it;
    ``gather_outputs_sequence_dim`` gives the whole sequence; Ulysses
    with zigzag is refused; ``split_inputs_sequence_dim`` defaults to
    the fleet's sep rank. At degree 1 the wrappers are full attention,
    as the JAX ones are."""
    q, k, v = _mk_qkv(s=16, h=2, d=4)
    got = pools(2).run("torch_cp_cases:wrappers", q, k, v)
    want = np.asarray(jcp.ring_flash_attention(
        *(paddle.Tensor(jnp.asarray(a)) for a in (q, k, v)),
        causal=True).jax())
    want_u = np.asarray(jcp.ulysses_attention(
        *(paddle.Tensor(jnp.asarray(a)) for a in (q, k, v)),
        causal=True).jax())
    for key in ("ring", "ulysses", "sep_ring", "sep_ulysses",
                "sep_allgather"):
        _close(np.concatenate([g[key] for g in got], axis=1), want, 2e-5)
    # sep_attention_manual: RoPE at the global positions (the JAX rope
    # module's tables over the whole sequence), then full attention
    from paddle_tpu.ops.pallas import rope as jrope
    s_tab, c_tab = jrope.build_sin_cos(q.shape[1], q.shape[-1], 10000.0,
                                       jnp.float32)
    pid = jnp.broadcast_to(jnp.arange(q.shape[1])[None], q.shape[:2])
    qr, kr = (jrope.apply_rope(jnp.asarray(a), s_tab, c_tab, pid)
              for a in (q, k))
    want_m = np.asarray(flash_attention_reference(qr, kr, jnp.asarray(v),
                                                  causal=True))
    for impl in ("ring", "ulysses", "allgather"):
        _close(np.concatenate([g["manual"][impl] for g in got], axis=1),
               want_m, 2e-5)
    for g in got:
        assert g["is_manual"] and not g["single_is_manual"]
        _close(g["gathered"], want, 2e-5)
        _close(g["single_ring"], want, 2e-5)
        _close(g["single_ulysses"], want_u, 2e-5)
        assert "only supported with impl='ring'" in g["zigzag_refused"]
    np.testing.assert_array_equal(got[1]["split"], np.arange(8, 16)[None])
