"""The port's disaggregated prefill/decode (the engine's migration verbs,
``paddle_tpu_torch.inference.disagg``) on the contracts of
tests/test_disagg.py and tests/test_quant_serving.py's migration cases,
and against the JAX package itself.

One tiny two-layer Llama in f32 (the JAX test's model, seed 0) serves
both packages: the port's weights come from the JAX model through
``convert``. The port's own cases hold its streams against its colocated
engine: the handoff round trip, one prefill/decode pair under both
schedulers, the import back into the source, the salvage of parked
migrations, a corrupt block rejected with the stream unchanged, a
geometry mismatch that replays, the codec round trip and its damage
tolerance, the role validation, the in-process DisaggServingFleet (its
metrics, no decode capacity, roles all "both"), int8 pages shipped with
a mixed-quant destination refused, and a payload chunked past a small
frame cap on a real transport. The cross-package cases move payloads
between the packages through the wire codecs in both directions (the
importing engine gives the exporting package's colocated streams), and
run the same DisaggServingFleet scenario through both packages (the same
streams, migration count and pages exported). The process-backed case
runs one prefill and one decode worker on the CPU. Streams are compared
exactly; int8 streams are held to their length and to the in-process
quantized pair's."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import inference as jinf
from paddle_tpu.inference import disagg as jdisagg
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM

from paddle_tpu_torch import convert
from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        DisaggServingFleet, ProcReplica)
from paddle_tpu_torch.inference.disagg import (kv_payload_from_wire,
                                               kv_payload_nbytes,
                                               kv_payload_to_wire)
from paddle_tpu_torch.inference.reliability import salvage_unfinished
from paddle_tpu_torch.inference.wire import WireTransport, socketpair
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

pytestmark = pytest.mark.disagg

torch.set_num_threads(1)

_ENG_KW = dict(num_slots=2, page_size=8, max_len=64, decode_chunk=4,
               prompt_buckets=(32,), greedy=True)
_KW = dict(_ENG_KW, device="cpu", audit=True)


@pytest.fixture(scope="module")
def models():
    """The JAX test's model (tiny, two layers, seed 0) and the port's
    with its weights."""
    cfg = JLlamaConfig.tiny()
    cfg.tensor_parallel = False
    cfg.scan_layers = False
    cfg.num_hidden_layers = 2
    paddle.seed(0)
    jm = JLlamaForCausalLM(cfg)
    jm.eval()
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tcfg = dataclasses.replace(LlamaConfig.tiny(), num_hidden_layers=2,
                               scan_layers=False)
    tm = convert.from_numpy_state_dict(
        LlamaForCausalLM(tcfg, device="cpu"), arrays)
    tm.eval()
    return {"jax": jm, "torch": tm, "vocab": cfg.vocab_size}


def _specs(vocab, seed=7):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, (n,)).astype(np.int32), k)
            for n, k in [(19, 5), (24, 6), (9, 4), (17, 1), (30, 5)]]


def _eng(models, **kw):
    return ContinuousBatchingEngine(models["torch"], **{**_KW, **kw})


def _jeng(models, **kw):
    return jinf.ContinuousBatchingEngine(models["jax"], **{**_ENG_KW, **kw})


def _colocated(make, specs):
    eng = make()
    ids = [eng.add_request(p, n) for p, n in specs]
    by = {r.request_id: r for r in eng.run()}
    return [by[i].tokens for i in ids]


@pytest.fixture(scope="module")
def oracle(models):
    """The port's colocated greedy streams for ``_specs``."""
    return _colocated(lambda: _eng(models), _specs(models["vocab"]))


@pytest.fixture(scope="module")
def joracle(models):
    """The JAX engine's colocated streams for ``_specs``."""
    return _colocated(lambda: _jeng(models), _specs(models["vocab"]))


def _drive_pair(pre, dec, n_reqs, turns=500, carry=lambda p: p):
    """A prefill engine and a decode engine with a manual pump (each
    payload through ``carry``); returns completions by id and the
    migration count."""
    done, migrated = {}, 0
    for _ in range(turns):
        for r in pre.step():
            done[r.request_id] = r
        for req, payload in pre.take_migrations():
            out = dec.import_migration(req, carry(payload))
            assert out["rejected"] == 0, out
            assert pre.release_exported(req.request_id)
            migrated += 1
        for r in dec.step():
            done[r.request_id] = r
        if len(done) == n_reqs and not pre.has_work() \
                and not dec.has_work():
            return done, migrated
    raise AssertionError(f"did not converge: {len(done)}/{n_reqs}")


def _first_export(eng, prompt, n_new):
    rid = eng.add_request(prompt, n_new)
    for _ in range(200):
        eng.step()
        if eng.migrations_out:
            break
    (req, payload), = eng.take_migrations()
    return rid, req, payload


# ---- the migration primitive in isolation ------------------------------

def test_handoff_reattach_round_trip_single_engine(models):
    """``handoff()`` mid-stream takes every page out, ``requeue`` puts
    them back on the same engine, the resumed streams equal an
    uncontended engine's and the audit balances."""
    specs = [(p, n + 12) for p, n in _specs(models["vocab"])]
    ref = _colocated(lambda: _eng(models), specs)
    eng = _eng(models)
    ids = [eng.add_request(p, n) for p, n in specs]
    done = {}
    for _ in range(200):
        for r in eng.step():
            done[r.request_id] = r
        if any(r.tokens for r in eng.slot_req if r is not None):
            break
    parked = eng.handoff()
    assert parked and not eng.has_work()
    eng._audit_pages("post-handoff")
    for req in parked:
        eng.requeue(req)
    done.update({r.request_id: r for r in eng.run()})
    assert [done[i].tokens for i in ids] == ref
    eng._audit_pages("post-reattach")


@pytest.mark.parametrize("unified", [True, False])
def test_migration_token_identity_single_pair(models, oracle, unified):
    """Export from a prefill-role engine, import into a decode-role
    engine: streams equal the colocated engine's, audits balance on both
    sides, the one-token request completes locally."""
    pre = _eng(models, unified=unified, role="prefill")
    dec = _eng(models, unified=unified, role="decode")
    ids = [pre.add_request(p, n) for p, n in _specs(models["vocab"])]
    done, migrated = _drive_pair(pre, dec, len(ids))
    assert [done[i].tokens for i in ids] == oracle
    assert migrated == 4
    assert pre._c_migrated_out.value == 4
    assert dec._c_kv_imported.value > 0 and dec._c_kv_rejects.value == 0
    pre._audit_pages("test")
    dec._audit_pages("test")
    hops = [h["kind"] for h in done[ids[0]].hops]
    assert "migrate_out" in hops and "migrate_in" in hops, hops


def test_import_back_into_source_engine(models, oracle):
    eng = _eng(models, role="prefill")
    prompt, n_new = _specs(models["vocab"])[0]
    rid, req, payload = _first_export(eng, prompt, n_new)
    assert eng.release_exported(req.request_id)
    assert not eng.release_exported(req.request_id)   # idempotent
    req.no_migrate = True
    out = eng.import_migration(req, payload)
    assert out["rejected"] == 0 and out["dedup"] == 2
    done = {r.request_id: r for r in eng.run()}
    assert done[rid].tokens == oracle[0]
    eng._audit_pages("test")


def test_salvage_includes_parked_migrations(models):
    eng = _eng(models, role="prefill")
    prompt, n_new = _specs(models["vocab"])[0]
    rid = eng.add_request(prompt, n_new)
    for _ in range(200):
        eng.step()
        if eng.migrations_out:
            break
    assert eng.migrations_out
    assert rid in [r.request_id for r in salvage_unfinished(eng)]
    # the pinned export counts in the audit until the ack
    assert eng._exported_pins
    eng._audit_pages("pinned")


# ---- degradation paths -------------------------------------------------

def test_corrupt_block_rejected_stream_still_identical(models, oracle):
    pre = _eng(models, role="prefill")
    dec = _eng(models, role="decode")
    prompt, n_new = _specs(models["vocab"])[1]        # 3 full pages
    rid, req, payload = _first_export(pre, prompt, n_new)
    blk = payload["blocks"][1]["data"][0]
    flat = np.asarray(blk).reshape(-1).copy()
    flat[0] = flat[0] + 1
    payload["blocks"][1]["data"][0] = flat.reshape(np.asarray(blk).shape)
    out = dec.import_migration(req, payload)
    assert out == {"imported": 1, "dedup": 0, "rejected": 1}
    assert dec._c_kv_rejects.value == 1
    pre.release_exported(req.request_id)
    done = {r.request_id: r for r in dec.run()}
    assert done[rid].tokens == oracle[1]
    dec._audit_pages("test")


@pytest.mark.parametrize("field", ["page_size", "dtype", "n_pools",
                                   "kv_quant"])
def test_geometry_mismatch_falls_back_to_replay(models, oracle, field):
    pre = _eng(models, role="prefill")
    dec = _eng(models, role="decode")
    prompt, n_new = _specs(models["vocab"])[0]
    rid, req, payload = _first_export(pre, prompt, n_new)
    bad = {"page_size": payload["page_size"] * 2, "dtype": "bfloat16",
           "n_pools": payload["n_pools"] + 1, "kv_quant": "int8"}[field]
    out = dec.import_migration(req, dict(payload, **{field: bad}))
    assert out == {"imported": 0, "dedup": 0, "rejected": 0}
    pre.release_exported(req.request_id)
    done = {r.request_id: r for r in dec.run()}
    assert done[rid].tokens == oracle[0]
    dec._audit_pages("test")


def test_codec_round_trip_and_damage_tolerance(models):
    pre = _eng(models, role="prefill")
    _, _, payload = _first_export(pre, _specs(models["vocab"])[0][0], 5)
    wire = kv_payload_to_wire(payload)
    assert wire["dtype"] == "float32" and wire["kv_quant"] == "none"
    back = kv_payload_from_wire(json.loads(json.dumps(wire)))
    assert back["eff_len"] == payload["eff_len"] == 19
    assert kv_payload_nbytes(back) == kv_payload_nbytes(payload) \
        == 2 * 2 * 2 * 2 * 8 * 16 * 4      # blocks x pools x [KVH, 8, D]
    for a, b in zip(back["blocks"], payload["blocks"]):
        assert list(a["tokens"]) == list(b["tokens"])
        assert a["crc"] == b["crc"]
        for x, y in zip(a["data"], b["data"]):
            assert x.tobytes() == np.ascontiguousarray(y).tobytes()
    bad = dict(wire, blocks=[{"tokens": [1], "data": ["!!"], "crc": [0]}])
    assert kv_payload_from_wire(bad)["blocks"] == []


def test_role_validation(models):
    with pytest.raises(ValueError):
        _eng(models, role="prefil")


# ---- the in-process fleet ----------------------------------------------

def _factory(models, **extra):
    def make(role="both"):
        return _eng(models, role=role, **extra)
    return make


def test_fleet_disagg_token_identity_and_metrics(models, oracle):
    fleet = DisaggServingFleet(_factory(models), num_prefill=1,
                               num_decode=1, hedge_delay_s=None)
    fids = [fleet.submit(p, n) for p, n in _specs(models["vocab"])]
    done = {r.request_id: r for r in fleet.run()}
    assert all(done[f].error is None for f in fids)
    assert [done[f].tokens for f in fids] == oracle
    assert fleet.metrics.counter("disagg/migrations").value == 4
    assert fleet.metrics.counter("disagg/migration_failures").value == 0
    assert fleet.metrics.counter("disagg/kv_bytes_moved").value > 0
    hops = [h["kind"] for h in done[fids[0]].hops]
    assert "migrate" in hops
    assert hops.index("migrate_out") < hops.index("migrate_in"), hops
    g = fleet.gauges()
    assert g["roles"] == {0: "prefill", 1: "decode"}
    assert g["migrations"] == 4 and g["migration_ms_p99"] > 0
    for rep in fleet.replicas.values():
        rep.engine._audit_pages("test")
        assert not rep.engine._exported_pins
    assert fleet.predicted_itl_s() is None or fleet.predicted_itl_s() > 0


def test_prefill_scale_up_warms_at_the_widest_bucket(models):
    """A warm ``scale_up(role="prefill")`` completes its one-token
    sacrificial request locally (a prefill engine parks anything longer)
    and leaves the replica idle and its gauges reset."""
    fleet = DisaggServingFleet(_factory(models), num_prefill=1,
                               num_decode=1, hedge_delay_s=None)
    rid = fleet.scale_up(role="prefill", warm=True)
    rep = fleet.replicas[rid]
    assert not rep.has_work() and not rep.engine.migrations_out
    assert rep.engine.gauges()["prefills"] == 0
    assert fleet.roles[rid] == "prefill" and rep.state == "ready"
    fleet.close()


def test_hedge_copies_are_never_orphaned_by_a_migration(models, oracle):
    """Hedges fire at once (a tiny factor, no floor), so the decode
    replica already runs a copy of most requests when their prefill
    migrates: the migration never lands on a replica holding a copy (it
    replays instead), every fleet id is delivered once with the colocated
    stream, and no replica is left with work or held pages."""
    fleet = DisaggServingFleet(_factory(models), num_prefill=1,
                               num_decode=1, hedge_delay_s=None,
                               hedge_factor=0.05, hedge_min_delay_s=0.0)
    specs = _specs(models["vocab"])
    fids = [fleet.submit(p, n) for p, n in specs]
    done = fleet.run()
    assert sorted(r.request_id for r in done) == sorted(fids)
    by = {r.request_id: r for r in done}
    assert [by[f].tokens for f in fids] == oracle
    assert fleet.gauges()["hedges"] > 0
    for rep in fleet.replicas.values():
        eng = rep.engine
        assert not rep.has_work()
        assert len(eng._free_pages) + eng.prefix_cache_pages \
            == eng.num_pages - 1
        eng._audit_pages("test")


def test_fleet_no_decode_capacity_degrades_colocated(models, oracle):
    fleet = DisaggServingFleet(_factory(models), num_prefill=1,
                               num_decode=0, hedge_delay_s=None)
    fids = [fleet.submit(p, n) for p, n in _specs(models["vocab"])]
    done = {r.request_id: r for r in fleet.run()}
    assert all(done[f].error is None for f in fids)
    assert [done[f].tokens for f in fids] == oracle
    assert fleet.metrics.counter("disagg/migration_failures").value >= 1
    assert fleet.metrics.counter("disagg/migrations").value == 0
    fleet.replicas[0].engine._audit_pages("test")


def test_fleet_both_roles_is_plain_fleet(models, oracle):
    fleet = DisaggServingFleet(_factory(models), num_prefill=0,
                               num_decode=0, hedge_delay_s=None)
    fleet.add_role_replica("both")
    fids = [fleet.submit(p, n) for p, n in _specs(models["vocab"])]
    done = {r.request_id: r for r in fleet.run()}
    assert [done[f].tokens for f in fids] == oracle
    assert fleet.metrics.counter("disagg/migrations").value == 0


# ---- quantized pages ---------------------------------------------------

def test_migration_ships_int8_pages_and_refuses_mixed_quant(models):
    """A prefill-role int8 engine's payload crosses the JSON codec (per
    pool shapes and dtypes, crc over codes and scales) into a same-quant
    decode engine; the pair's streams equal the colocated int8 engine's.
    A full-precision destination refuses the pages and still completes
    the request by tokens-only replay."""
    specs = _specs(models["vocab"])
    want = _colocated(lambda: _eng(models, kv_quant="int8"), specs)
    pre = _eng(models, kv_quant="int8", role="prefill")
    dec = _eng(models, kv_quant="int8", role="decode")
    ids = [pre.add_request(p, n) for p, n in specs]

    def carry(payload):
        assert payload["kv_quant"] == "int8"
        wire = json.loads(json.dumps(kv_payload_to_wire(payload)))
        assert len(set(map(tuple, wire["shapes"]))) == 2   # codes, scales
        assert wire["dtypes"][:4] == ["int8", "int8", "float32",
                                      "float32"]
        return kv_payload_from_wire(wire)

    done, migrated = _drive_pair(pre, dec, len(ids), carry=carry)
    assert migrated == 4 and dec._c_kv_imported.value > 0
    assert [done[i].tokens for i in ids] == want
    pre2 = _eng(models, kv_quant="int8", role="prefill")
    rid, req, payload = _first_export(pre2, *specs[0])
    mixed = _eng(models, role="decode")
    res = mixed.import_migration(req, kv_payload_from_wire(
        json.loads(json.dumps(kv_payload_to_wire(payload)))))
    assert res["imported"] == 0
    out = {r.request_id: r for r in mixed.run()}
    assert len(out[rid].tokens) == specs[0][1]


def test_migration_kv_bytes_drop_on_wire(models):
    p = _specs(models["vocab"], seed=19)[1][0]

    def wire_len(kvq):
        e = _eng(models, kv_quant=kvq, role="prefill")
        e.add_request(p, 4)
        e.run()
        return len(json.dumps(kv_payload_to_wire(
            e.take_migrations()[0][1])))

    assert wire_len("none") / wire_len("int8") > 1.5


def test_payload_chunked_past_the_frame_cap_imports(models, oracle):
    """A real payload through a transport whose frame cap it passes:
    the chunked group reassembles, the import takes every block and the
    stream is the colocated one."""
    pre = _eng(models, role="prefill")
    dec = _eng(models, role="decode")
    prompt, n_new = _specs(models["vocab"])[4]          # 3 full pages
    rid, req, payload = _first_export(pre, prompt, n_new)
    a, b = socketpair()
    ta = WireTransport(a, side="worker", max_frame=4096)
    tb = WireTransport(b, side="worker", max_frame=4096)
    try:
        ta.send({"op": "kv_import", "payload": kv_payload_to_wire(payload)})
        got = tb.recv(5.0)
    finally:
        ta.close()
        tb.close()
    assert tb._send_seq == 0 and got["seq"] > 3       # many chunk frames
    out = dec.import_migration(req, kv_payload_from_wire(got["payload"]))
    assert out == {"imported": 3, "dedup": 0, "rejected": 0}
    done = {r.request_id: r for r in dec.run()}
    assert done[rid].tokens == oracle[4]


# ---- against the JAX package -------------------------------------------

def test_port_engine_streams_equal_jax_engines(oracle, joracle):
    """The premise of the cross-package cases: on the carried weights
    the two packages' colocated streams are equal."""
    assert oracle == joracle


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_payloads_cross_between_the_packages(models, joracle, direction):
    """Every migration of a prefill engine of one package, carried by
    its codec over JSON and taken off by the other package's codec,
    imports into the other package's decode engine with no rejection,
    and the pair's streams are the colocated JAX streams."""
    specs = _specs(models["vocab"])
    if direction == "jax_to_port":
        pre = _jeng(models, role="prefill")
        dec = _eng(models, role="decode")
        to_wire, from_wire = jdisagg.kv_payload_to_wire, \
            kv_payload_from_wire
    else:
        pre = _eng(models, role="prefill")
        dec = _jeng(models, role="decode")
        to_wire, from_wire = kv_payload_to_wire, \
            jdisagg.kv_payload_from_wire
    seen = []

    def carry(payload):
        wire = json.loads(json.dumps(to_wire(payload)))
        seen.append(wire)
        return from_wire(wire)

    ids = [pre.add_request(p, n) for p, n in specs]
    done, migrated = _drive_pair(pre, dec, len(ids), carry=carry)
    assert migrated == 4
    assert dec._c_kv_imported.value == sum(len(w["blocks"]) for w in seen)
    assert [done[i].tokens for i in ids] == joracle
    assert {w["dtype"] for w in seen} == {"float32"}


def test_exported_payload_matches_the_jax_engines(models):
    """The port's payload is the JAX engine's: the same keys, geometry,
    token blocks and per-pool shapes on the wire, and page content within
    1e-5 (f32 on the carried weights; bits may differ by the order of the
    matmuls' sums)."""
    prompt, n_new = _specs(models["vocab"])[1]
    _, _, tp = _first_export(_eng(models, role="prefill"), prompt, n_new)
    _, _, jp = _first_export(_jeng(models, role="prefill"), prompt, n_new)
    tw, jw = kv_payload_to_wire(tp), jdisagg.kv_payload_to_wire(jp)
    assert set(tw) == set(jw)
    for k in ("version", "eff_len", "page_size", "n_pools", "dtype",
              "kv_quant", "shape", "shapes", "dtypes"):
        assert tw[k] == jw[k], k
    assert [b["tokens"] for b in tw["blocks"]] \
        == [b["tokens"] for b in jw["blocks"]]
    for a, b in zip(tp["blocks"], jp["blocks"]):
        for x, y in zip(a["data"], b["data"]):
            np.testing.assert_allclose(x, np.asarray(y), rtol=0, atol=1e-5)


def test_disagg_fleet_equals_the_jax_fleet(models, joracle):
    """The same DisaggServingFleet scenario (one prefill, one decode
    replica) through both packages: the same streams, migration count,
    pages exported and bytes moved."""
    specs = _specs(models["vocab"])
    out = {}
    for side, (fleet_cls, make) in {
            "jax": (jinf.DisaggServingFleet,
                    lambda role="both": _jeng(models, role=role)),
            "torch": (DisaggServingFleet, _factory(models))}.items():
        # no hedges: their delays read the clock, and the sides must
        # route alike
        fleet = fleet_cls(make, num_prefill=1, num_decode=1,
                          hedge_delay_s=1e9)
        fids = [fleet.submit(p, n) for p, n in specs]
        done = {r.request_id: r for r in fleet.run()}
        g = fleet.gauges()
        out[side] = {
            "streams": [done[f].tokens for f in fids],
            "migrations": g["migrations"],
            "bytes": g["kv_bytes_moved"],
            "exported": fleet.replicas[0].engine._c_kv_exported.value}
    assert out["torch"] == out["jax"]
    assert out["torch"]["streams"] == joracle


# ---- process-backed ----------------------------------------------------

def test_proc_disagg_fleet_streams_equal_colocated(models, monkeypatch):
    """One prefill and one decode worker on the CPU: the payloads ride
    take_migrations / kv_import / kv_release over the wire, every
    migration lands, no pin is left on the source after the acks, and
    the streams equal the in-process colocated engine's over the same
    seeded factory."""
    from paddle_tpu_torch.inference.worker import llama_engine
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    kw = dict(model="tiny", num_hidden_layers=2, seed=3, device="cpu",
              **_ENG_KW)
    specs = _specs(models["vocab"])
    want = _colocated(lambda: llama_engine(**kw), specs)
    spec = {"factory": "paddle_tpu_torch.inference.worker:llama_engine",
            "kwargs": kw}
    fleet = DisaggServingFleet(
        spec, num_prefill=1, num_decode=1, hedge_delay_s=None,
        replica_cls=ProcReplica,
        replica_kwargs=dict(init_deadline_s=120.0, rpc_hard_deadline_s=60.0,
                            hb_timeout_s=5.0))
    try:
        fids = [fleet.submit(p, n) for p, n in specs]
        done = {r.request_id: r for r in fleet.run()}
        assert all(done[f].error is None for f in fids)
        assert [done[f].tokens for f in fids] == want
        g = fleet.gauges()
        assert g["migrations"] == 4 and g["migration_failures"] == 0
        for rep in fleet.replicas.values():
            audit = rep.audit()
            assert audit["clean"] and audit["pins"] == 0
        assert fleet.replicas[1].engine.metrics.counter(
            "disagg/kv_imported_pages").value > 0
        assert fleet.replicas[1].engine.metrics.counter(
            "disagg/kv_import_crc_rejects").value == 0
    finally:
        fleet.close()
