"""Disaggregated prefill/decode serving: the port of
``paddle_tpu/inference/disagg.py``.

Long prompts stall a colocated decode batch: every scheduler turn a
replica spends streaming a 2k-token prompt is a turn its short-chat
occupants wait for their next token. The scale-out answer is to split
the fleet by phase: **prefill replicas** only ingest prompts, **decode
replicas** only stream tokens, and finished prompt-KV pages migrate
between them.

This module composes primitives the port already has:

- the paged KV layout makes the handoff a per-page copy:
  :meth:`~.serving.ContinuousBatchingEngine._migrate_out` exports full
  prompt pages with per-pool crc32s, and
  :meth:`~.serving.ContinuousBatchingEngine.import_migration` seeds them
  into the destination's prefix-cache radix index, so the decode replica
  attaches them exactly like a prefix-cache hit at full match length
  and re-prefills only the unseen suffix;
- greedy streams therefore go on as the colocated engine's would, by the
  same recompute-replay contract every failover path leans on, and a
  lost or damaged transfer degrades to plain prompt replay, never a
  wrong stream;
- the crc-framed wire and the shadow salvage of :mod:`.proc_replica`
  give the cross-process transfer its fault model: the payload rides the
  ``take_migrations``/``kv_import``/``kv_release`` RPCs (chunked past
  the frame cap), a prefill worker dying mid-transfer salvages to prompt
  replay off the parent's shadow, a decode worker dying mid-decode
  salvages its emitted tokens through the breaker/retry path;
- the router gains role awareness: new prompts land on prefill-capable
  replicas (decode replicas are ordinary engines, so they still take
  traffic when every prefill replica is gone: cross-role failover),
  migrations target the least-occupied decode-capable replica, the
  migration leg lands in hop timelines and the federated ``disagg/*``
  metrics, and admission quotes TTFT off prefill queue depth while
  :meth:`DisaggServingFleet.predicted_itl_s` quotes ITL off decode
  occupancy.

The payload codec is the JAX package's: a payload one package puts on
the wire, the other takes off it. bf16 and fp8 pages, which numpy has no
dtype for, are carried as their raw bits (``uint16`` / ``uint8``) and
named on the wire by their JAX names (``"bfloat16"``,
``"float8_e4m3fn"``).

Failure matrix (who salvages what — pinned by ``tests/test_torch_disagg.py``):

===========================  ==========================================
event                        recovery
===========================  ==========================================
prefill replica dies         parked + in-flight requests salvage to
mid-transfer                 prompt replay on a sibling (shadow /
                             ``salvage_unfinished`` — payload is lost,
                             correctness never depended on it)
decode replica dies          emitted tokens salvage through the
mid-decode                   breaker/retry path; replay re-prefills
                             prompt + tokens anywhere (cross-role)
import fails / no decode     ``disagg/migration_failures``; the fleet
candidate                    re-routes the request for plain replay
payload damaged (crc)        destination stops seeding at the bad
                             block, requeues; suffix re-prefills
source never acked           exported pages stay pinned (audit counts
                             them) until ``release_exported``; an
                             engine rebuild drops pins with the index
===========================  ==========================================
"""

from __future__ import annotations

import base64
import time

import numpy as np

from ..profiler import flight_recorder as _frec
from ..profiler import metrics as _pmetrics
from .fleet import ServingFleet
from .serving import ServedRequest, record_hop

__all__ = ["DisaggServingFleet", "kv_payload_to_wire",
           "kv_payload_from_wire", "kv_payload_nbytes"]

# fleet-side migration vocabulary
_pmetrics.declare("disagg/migrations", "counter",
                  "prefill->decode KV migrations completed (payload "
                  "imported, source acked)")
_pmetrics.declare("disagg/migration_failures", "counter",
                  "migrations that could not land on a decode replica "
                  "(no candidate, import error, dead destination) — "
                  "the request re-routed for plain prompt replay")
_pmetrics.declare("disagg/migration_ms", "histogram",
                  "per completed migration: router pickup of the "
                  "exported payload -> destination import ack, ms "
                  "(bounded reservoir)")
_pmetrics.declare("disagg/kv_bytes_moved", "counter",
                  "KV page content bytes carried by completed "
                  "migrations (pre-encoding payload size)")
_pmetrics.declare("disagg/prefill_queue_depth", "gauge",
                  "requests queued across prefill-capable replicas — "
                  "the per-role depth TTFT quotes ride")
_pmetrics.declare("disagg/decode_queue_depth", "gauge",
                  "requests queued + running across decode-capable "
                  "replicas — the occupancy ITL quotes ride")


# ---- kv_transfer payload codec (the wire carries JSON) -------------------

#: numpy carriers of the dtypes numpy lacks, by their JAX names
_CARRIERS = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8}
_CARRIED = {np.dtype(v): k for k, v in _CARRIERS.items()}


def _wire_name(arr):
    """The JAX name of a page's dtype (a carrier reads as its dtype)."""
    return _CARRIED.get(arr.dtype, str(arr.dtype))


def _np_dtype(name):
    return np.dtype(_CARRIERS.get(name, name))

def kv_payload_to_wire(payload):
    """Engine migration payload (numpy page content) -> JSON-safe
    ``kv_transfer`` form: page data base64-encoded per pool, tokens and
    checksums as plain ints, one shared ``shape`` (every page block of
    a pool has identical geometry). The per-page crc32s computed at
    export ride along and are re-verified at import — corruption
    between the two b64 codecs (or a buggy transport) is caught by
    checksum, not trusted.

    Quantized KV ships natively — the int8 page codes and
    their f32 scale pages are b64-encoded as exported, no
    dequant→requant round trip — so pool geometry is heterogeneous:
    per-pool ``shapes``/``dtypes`` lists (from the first block) ride
    next to the legacy shared ``shape``/``dtype`` fields, and the
    engine's ``kv_quant`` mode passes through for the destination's
    geometry handshake."""
    out = {k: payload[k] for k in ("version", "rid", "eff_len",
                                   "page_size", "n_pools", "dtype")}
    if "kv_quant" in payload:
        out["kv_quant"] = payload["kv_quant"]
    shape = None
    shapes = dtypes = None
    blocks = []
    for blk in payload["blocks"]:
        if shape is None and blk["data"]:
            shape = [int(x) for x in np.asarray(blk["data"][0]).shape]
            shapes = [[int(x) for x in np.asarray(d).shape]
                      for d in blk["data"]]
            dtypes = [_wire_name(np.asarray(d)) for d in blk["data"]]
        blocks.append({
            "tokens": [int(t) for t in blk["tokens"]],
            "data": [base64.b64encode(
                np.ascontiguousarray(d).tobytes()).decode("ascii")
                for d in blk["data"]],
            "crc": [int(c) for c in blk["crc"]],
        })
    out["shape"] = shape
    if shapes is not None:
        out["shapes"] = shapes
        out["dtypes"] = dtypes
    out["blocks"] = blocks
    return out


def kv_payload_from_wire(obj):
    """Inverse of :func:`kv_payload_to_wire`: rebuild the numpy-form
    payload ``import_migration`` consumes. Malformed input degrades to
    an empty block list (the request still replays from its prompt) —
    a damaged transfer must never raise past the import seam."""
    out = {k: obj.get(k) for k in ("version", "rid", "eff_len",
                                   "page_size", "n_pools", "dtype")}
    if "kv_quant" in obj:
        out["kv_quant"] = obj["kv_quant"]
    blocks = []
    try:
        # per-pool geometry when present (quantized payloads mix int8
        # data pools with f32 scales pools); legacy single-shape
        # payloads fall back to the shared fields
        if obj.get("shapes"):
            shapes = [tuple(int(x) for x in s) for s in obj["shapes"]]
            dts = [_np_dtype(str(d)) for d in obj["dtypes"]]
        else:
            shapes = dts = None
            dt = _np_dtype(str(obj.get("dtype")))
            shape = tuple(int(x) for x in obj.get("shape") or ())
        for blk in obj.get("blocks") or []:
            blocks.append({
                "tokens": np.asarray(blk["tokens"], np.int32),
                "data": [np.frombuffer(
                    base64.b64decode(s),
                    dts[i] if dts is not None else dt).reshape(
                        shapes[i] if shapes is not None else shape)
                    for i, s in enumerate(blk["data"])],
                "crc": [int(c) for c in blk["crc"]],
            })
    except Exception:  # noqa: BLE001 — damaged payload: plain replay
        blocks = []
    out["blocks"] = blocks
    return out


def kv_payload_nbytes(payload):
    """Raw KV content bytes in a numpy-form payload (the
    ``disagg/kv_bytes_moved`` accounting unit)."""
    return sum(int(np.asarray(d).nbytes)
               for blk in payload.get("blocks") or ()
               for d in blk["data"])


# ---- the role-aware fleet ----------------------------------------------

class DisaggServingFleet(ServingFleet):
    """A :class:`~.fleet.ServingFleet` whose replicas carry a role —
    ``prefill`` | ``decode`` | ``both`` — with the router, migration
    scheduler and per-role SLO quoting on top (module docstring).

    ``engine_factory`` is either a callable accepting a ``role=``
    keyword (in-process replicas) or a ProcReplica worker spec dict
    (``{"factory": ..., "kwargs": {...}}``) whose kwargs gain the role;
    every replica inherits its role across supervised rebuilds and
    worker respawns because the role is baked into its factory/spec.

    Routing: new admissions prefer prefill-capable replicas (role !=
    "decode"); decode replicas absorb admissions only when no prefill
    replica will — the cross-role failover path. Migration imports
    target the least-loaded decode-capable replica. Everything else —
    breakers, hedging, exactly-once delivery, salvage — is the base
    router, unchanged."""

    def __init__(self, engine_factory, num_prefill=1, num_decode=1,
                 **kw):
        #: replica id -> role; consulted by the router overrides
        self.roles: dict[int, str] = {}
        super().__init__(engine_factory, num_replicas=0, **kw)
        self._h_migration = self.metrics.histogram("disagg/migration_ms")
        for _ in range(int(num_prefill)):
            self.add_role_replica("prefill")
        for _ in range(int(num_decode)):
            self.add_role_replica("decode")

    # -- role plumbing -----------------------------------------------------

    def _role_factory(self, role):
        base = self._factory
        if isinstance(base, dict):          # ProcReplica worker spec
            kw = dict(base.get("kwargs", {}))
            kw["role"] = role
            out = dict(base)
            out["kwargs"] = kw
            return out
        return lambda: base(role=role)

    def add_role_replica(self, role):
        """Register one replica with ``role`` baked into its factory
        (no warmup — mirrors the base ctor's initial registration)."""
        rep = self._add_replica(self._role_factory(role))
        self.roles[rep.id] = role
        return rep.id

    def scale_up(self, engine_factory=None, warm=True, role="both"):
        """Base :meth:`~.fleet.ServingFleet.scale_up` (warm before
        weight), with the new replica's role recorded; an explicit
        ``engine_factory`` is used as-is and simply tagged. The role is
        recorded before the warm-up, so a prefill replica warms as one
        (the JAX fleet records it after, and its prefill replica parks
        the base warm-up request, which the pump then drops)."""
        self.roles[self._next_replica_id] = role
        rid = super().scale_up(
            engine_factory or self._role_factory(role), warm=warm)
        self.roles[rid] = role
        return rid

    def _warm(self, rep):
        """Role-aware warmup. A prefill-role engine parks any request
        that still needs tokens after its first, and only the fleet's
        migration pump collects parked requests, so the base
        sacrificial request would never finish and the warm loop would
        spin to its step bound. One generated token runs the step's
        kernels (slot activation is data, not shape), so prefill
        replicas warm with ``max_new=1`` and complete locally. The
        sacrificial prompt is as long as the engine's widest prompt
        bucket: a prefill replica exists to take long prompts, so its
        warm-up runs the prefill at the width it will serve."""
        if self._role(rep) != "prefill":
            return super()._warm(rep)
        eng = rep.engine
        buckets = getattr(eng, "prompt_buckets", None)
        plen = int(max(buckets)) if buckets \
            else 2 * int(getattr(eng, "page_size", 8))
        plen = max(4, min(plen, int(eng.max_len) - 2))
        wreq = ServedRequest(-1, np.zeros((plen,), np.int32), 1, None)
        wreq.t_arrive = time.perf_counter()
        eng.requeue(wreq)
        for _ in range(512):
            if not rep.has_work():
                break
            rep.step()
        eng.reset_gauges()

    def _role(self, rep):
        return self.roles.get(rep.id, "both")

    def _prefill_capable(self, rep):
        return self._role(rep) != "decode"

    def _decode_capable(self, rep):
        return self._role(rep) != "prefill"

    # -- role-aware routing ------------------------------------------------

    def _candidates(self, exclude=(), prefer=None):
        # base order (health, least-loaded, affinity, p99), then a
        # STABLE partition: prefill-capable replicas first. _assign
        # walks candidates in order, so decode replicas take new
        # admissions only when every prefill-capable replica is gone
        # or shedding — cross-role failover without a special path.
        reps = super()._candidates(exclude, prefer)
        reps.sort(key=lambda r: 0 if self._prefill_capable(r) else 1)
        return reps

    def _pick_decode(self, exclude=()):
        """Migration target: the least-occupied decode-capable ready
        replica (never the source)."""
        cands = [r for r in self.replicas.values()
                 if r.takes_weight() and r.id not in exclude
                 and self._decode_capable(r)]
        if not cands:
            return None
        return min(cands, key=lambda r: (r.load(), r.id))

    # -- migration scheduling ----------------------------------------------

    def step(self):
        done = super().step()
        self._pump_migrations()
        self._emit_role_gauges()
        return done

    def _pump_migrations(self):
        """Drain every prefill replica's exported (request, payload)
        pairs and land each on a decode replica: import (the payload
        becomes destination prefix-cache residents + a requeue), move
        the attempt's ownership, ack the source so its pinned pages
        become ordinary cache. Any failure re-routes the request for
        plain prompt replay through the base retry machinery — a
        migration can be lost, the request cannot."""
        for rep in list(self.replicas.values()):
            if not rep.live() or not self._prefill_capable(rep):
                continue
            try:
                migrations = rep.take_migrations()
            except (KeyboardInterrupt, SystemExit, AssertionError):
                raise
            except Exception:  # noqa: BLE001 — dead/hung source: its
                continue       # parked requests salvage via the shadow
            for req, payload in migrations:
                self._migrate_one(rep, req, payload)

    def _migrate_one(self, src, req, payload):
        t0 = time.perf_counter()
        tr = self._reqs.get(req.request_id)
        if tr is None or tr.done is not None or tr.cancelled:
            # decided/cancelled while parked: nothing to move — just
            # unpin the source (the reap owns the typed completion)
            self._release_quiet(src, req.request_id)
            if tr is not None and tr.cancelled and tr.done is None:
                tr.attempts.pop(src.id, None)
                tr.carry = req       # the pending reap completes it
            return
        # never a replica already running a (hedge) copy of this request:
        # two attempts of one fleet id in one engine share its id, and
        # the JAX fleet's import there orphans the copy, which then runs
        # on after the request is delivered
        dest = self._pick_decode(exclude=(src.id, *tr.attempts))
        err = None
        if dest is not None:
            try:
                dest.import_migration(req, payload)
            except (KeyboardInterrupt, SystemExit, AssertionError):
                raise
            except Exception as exc:  # noqa: BLE001 — failed import
                err = exc              # degrades to prompt replay
        if dest is None or err is not None:
            self.metrics.counter("disagg/migration_failures").inc()
            record_hop(req, "migrate_failed",
                       src=src.id,
                       dest=dest.id if dest is not None else None,
                       error=repr(err)[:80] if err else "no candidate")
            _frec.record_event("disagg_migrate_failed", fid=tr.fid,
                               src=src.id, error=repr(err)[:120]
                               if err else "no candidate")
            self._release_quiet(src, req.request_id)
            # prompt replay on whatever replica admission picks next
            # turn — an infrastructure miss, not a request failure, so
            # no retry budget burns (the drain-eviction discipline).
            # no_migrate pins the replay colocated: without it a
            # decode-fleet outage would loop prefill -> park -> fail
            # forever instead of degrading to a colocated stream
            req.no_migrate = True
            tr.attempts.pop(src.id, None)
            tr.carry = req
            tr.not_before = time.perf_counter()
            self.metrics.counter("fleet/requeued").inc()
            return
        # success: ownership moves src -> dest, source unpins
        tr.attempts.pop(src.id, None)
        tr.attempts[dest.id] = req
        self._release_quiet(src, req.request_id)
        ms = (time.perf_counter() - t0) * 1e3
        moved = kv_payload_nbytes(payload)
        self.metrics.counter("disagg/migrations").inc()
        self.metrics.counter("disagg/kv_bytes_moved").inc(moved)
        self._h_migration.observe(ms)
        record_hop(req, "migrate", src=src.id, dest=dest.id,
                   pages=len(payload.get("blocks") or ()),
                   bytes=moved, ms=round(ms, 3))
        _frec.record_event("disagg_migrate", fid=tr.fid, src=src.id,
                           dest=dest.id, bytes=moved,
                           ms=round(ms, 3))

    @staticmethod
    def _release_quiet(src, request_id):
        try:
            src.release_exported(request_id)
        except (KeyboardInterrupt, SystemExit, AssertionError):
            raise
        except Exception:  # noqa: BLE001 — a dead source has no pins
            pass           # left to release (its index died with it)

    # -- per-role SLO quoting ----------------------------------------------

    def prefill_queue_depth(self):
        """Requests waiting across prefill-capable replicas — the
        depth new-admission TTFT quotes ride (admission controllers on
        prefill replicas already fold their own queue drain into
        :meth:`~.reliability.AdmissionController.predicted_ttft_s`;
        this is the fleet-level gauge of the same signal)."""
        return sum(len(r.engine.queue) for r in self.replicas.values()
                   if r.live() and self._prefill_capable(r))

    def decode_queue_depth(self):
        """Queued + running requests across decode-capable replicas."""
        n = 0
        for r in self.replicas.values():
            if not r.live() or not self._decode_capable(r):
                continue
            n += len(r.engine.queue)
            n += sum(1 for q in r.engine.slot_req
                     if q is not None and not q.finished)
        return n

    def predicted_ttft_s(self):
        """Fleet TTFT quote for a request submitted NOW: the best
        prefill-capable replica's admission prediction (their
        controllers read prefill queue depth by construction — new
        prompts only land there). None while no history exists."""
        preds = []
        for r in self.replicas.values():
            if r.takes_weight() and self._prefill_capable(r):
                p = r.admission.predicted_ttft_s()
                if p is not None:
                    preds.append(p)
        return min(preds) if preds else None

    def predicted_itl_s(self):
        """Fleet ITL quote: the best decode-capable replica's observed
        itl p50, scaled by decode occupancy (a full decode pool shares
        scheduler turns across more streams). None while cold."""
        p50s, slots, busy = [], 0, 0
        for r in self.replicas.values():
            if not r.takes_weight() or not self._decode_capable(r):
                continue
            h = r.engine.metrics.get("serving/itl_ms")
            if h is not None and h.count:
                p50s.append(h.percentile(50) / 1e3)
            slots += max(1, r.engine.num_slots)
            busy += sum(1 for q in r.engine.slot_req
                        if q is not None and not q.finished)
        if not p50s:
            return None
        occupancy = busy / max(1, slots)
        return min(p50s) * (1.0 + occupancy)

    def _emit_role_gauges(self):
        self.metrics.gauge("disagg/prefill_queue_depth").set(
            self.prefill_queue_depth())
        self.metrics.gauge("disagg/decode_queue_depth").set(
            self.decode_queue_depth())

    # -- observability -----------------------------------------------------

    def gauges(self) -> dict:
        g = super().gauges()

        def c(name):
            return self.metrics.counter(name).value

        g.update({
            "roles": dict(self.roles),
            "migrations": c("disagg/migrations"),
            "migration_failures": c("disagg/migration_failures"),
            "kv_bytes_moved": c("disagg/kv_bytes_moved"),
            "migration_ms_p99": self._h_migration.percentile(99),
            "prefill_queue_depth": self.prefill_queue_depth(),
            "decode_queue_depth": self.decode_queue_depth(),
        })
        return g
