"""Replica worker process: ``python -m paddle_tpu_torch.inference.worker
--fd N --hb-interval S``; the port of ``paddle_tpu/inference/worker.py``.

Owns one :class:`~.serving.ContinuousBatchingEngine` and serves the
parent's RPCs (``init``, ``clock``, ``ping``, ``admit``, ``step``,
``cancel``, ``handoff``, ``take_migrations``, ``kv_import``,
``kv_release``, ``reset_gauges``, ``audit``, ``shutdown``) over the
:mod:`~.wire` frame protocol on an inherited socket fd. Design points,
all in service of the parent's dead/hung/lossy classification:

- **Heartbeats.** A daemon thread sends ``{"kind": "hb"}`` every
  ``hb_interval_s`` from the moment the transport is up, before torch is
  imported and before the first CUDA call, so a busy worker is never
  taken for a hung one and a SIGSTOPped worker goes silent within one
  interval. This module imports only the standard library and the wire
  at load time.
- **Exactly-once RPCs.** Replies are cached by rpc id (bounded); a
  retransmitted request (the parent's answer to a dropped frame) gets the
  cached reply without running again, so an ``admit`` or a ``step`` is
  never applied twice.
- **Incremental harvest.** Every ``step`` reply carries only the new
  tokens and hops of each request since the last report (the parent
  mirrors them into its shadow requests: the salvage-from-shadow
  guarantee), plus a registry snapshot diff the parent folds into its
  shadow registry.
- **Fail loudly.** An ``AssertionError`` (the page audit) or any other
  exception of the engine sends one ``fatal`` frame and exits nonzero:
  the parent re-raises the audit (never laundered into a respawn) or
  respawns under its budget.

Beyond the JAX worker's replies, ``init`` names the device the engine
runs on and the seconds its factory took (imports included), and
``audit`` reports the engine's forwards and each serving
kernel wrapper's ``launches`` counter (zeroed with the gauges), whether
this process compiled the kernels (or loaded a library already built),
and the migrated-out prefixes still pinned, so a caller can hold the
kernels' launches a forward and the migration acks across the process
boundary.
"""

from __future__ import annotations

import argparse
import importlib
import os
import socket
import sys
import threading
import time

from .wire import WireClosed, WireError, WireTimeout, WireTransport

_REPLY_CACHE = 16

#: the serving kernels whose launch counters ``audit`` reports
SERVING_KERNELS = ("rms_norm", "swiglu", "ragged_paged_attention",
                   "ragged_paged_attention_quant")


def llama_engine(model="tiny", num_hidden_layers=1, seed=0, dtype=None,
                 device=None, **engine_kw):
    """The standard worker engine factory (spec-addressable as
    ``paddle_tpu_torch.inference.worker:llama_engine``): a ``LlamaConfig``
    preset (``model``, cut to ``num_hidden_layers``, unrolled), its
    weights drawn from a generator seeded by ``seed``, in ``dtype`` (a
    torch dtype or its name; f32 when None), and a
    ContinuousBatchingEngine around it, on ``device`` (``cuda`` unless
    given). The same seed on every worker gives the same weights, so
    greedy streams are equal across replicas and respawns."""
    import dataclasses

    import torch

    from ..models import LlamaConfig, LlamaForCausalLM
    from .serving import ContinuousBatchingEngine

    cfg = dataclasses.replace(getattr(LlamaConfig, model)(),
                              scan_layers=False)
    if num_hidden_layers:
        cfg = dataclasses.replace(cfg,
                                  num_hidden_layers=int(num_hidden_layers))
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    m = LlamaForCausalLM(cfg, device=device, dtype=dtype or torch.float32,
                         seed=int(seed))
    m.eval()
    if "prompt_buckets" in engine_kw:
        engine_kw["prompt_buckets"] = tuple(engine_kw["prompt_buckets"])
    engine_kw.setdefault("greedy", True)
    return ContinuousBatchingEngine(m, device=device, **engine_kw)


def _resolve_factory(dotted):
    """``pkg.mod:attr`` (or ``pkg.mod.attr``) -> callable."""
    if ":" in dotted:
        mod, attr = dotted.split(":", 1)
    else:
        mod, attr = dotted.rsplit(".", 1)
    return getattr(importlib.import_module(mod), attr)


def _rss_bytes():
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGESIZE")
    except (OSError, ValueError, IndexError):
        return 0


def _kernel_wrappers():
    """name -> the serving kernels' wrappers (each holds ``launches``)."""
    out = {}
    for name in SERVING_KERNELS:
        mod = "ragged_paged_attention" if name.startswith("ragged") \
            else name
        module = importlib.import_module(
            f"paddle_tpu_torch.ops.kernels.{mod}")
        out[name] = getattr(module, name)
    return out


def _device_name(eng):
    dev = getattr(eng, "device", None)
    if dev is None or dev.type != "cuda":
        return str(dev) if dev is not None else "cpu"
    import torch
    return torch.cuda.get_device_name(dev)


class Worker:
    def __init__(self, transport):
        self.tr = transport
        self.engine = None
        #: rid -> [tokens reported, hops reported]
        self._reported: dict[int, list] = {}
        #: bounded exactly-once reply cache: rpc id -> reply body
        self._replies: dict[int, dict] = {}
        self._reply_order: list[int] = []
        #: last counters/gauges snapshot sent (diff base)
        self._sent_counters: dict[str, float] = {}
        self._sent_hist_counts: dict[str, int] = {}

    # -- protocol loop -------------------------------------------------

    def serve(self):
        while True:
            try:
                msg = self.tr.recv(timeout_s=60.0)
            except WireTimeout:
                continue             # quiet parent; keep serving
            except (WireClosed, OSError):
                return               # parent gone: exit cleanly
            except WireError:
                continue             # corrupt inbound; decoder resynced
            if msg.get("kind") != "rpc":
                continue
            rid, op = msg.get("id"), msg.get("op")
            if rid in self._replies:
                self.tr.send({"kind": "reply", "id": rid,
                              **self._replies[rid]})
                continue
            try:
                body = self._handle(op, msg)
            except Exception as e:  # noqa: BLE001 — fatal by contract
                try:
                    self.tr.send({"kind": "fatal",
                                  "etype": type(e).__name__,
                                  "msg": str(e)[:500]})
                except WireError:
                    pass
                raise
            body["ok"] = True
            self._replies[rid] = body
            self._reply_order.append(rid)
            if len(self._reply_order) > _REPLY_CACHE:
                self._replies.pop(self._reply_order.pop(0), None)
            self.tr.send({"kind": "reply", "id": rid, **body})
            if op == "shutdown":
                return

    # -- ops -----------------------------------------------------------

    def _handle(self, op, msg):
        if op == "init":
            spec = msg["spec"]
            t0 = time.perf_counter()
            factory = _resolve_factory(spec["factory"])
            self.engine = factory(**spec.get("kwargs", {}))
            eng = self.engine
            return {"pid": os.getpid(),
                    "device": _device_name(eng),
                    "factory_s": time.perf_counter() - t0,
                    "geom": {"num_slots": eng.num_slots,
                             "page_size": eng.page_size,
                             "max_len": eng.max_len,
                             "decode_chunk": eng.decode_chunk,
                             "num_pages": eng.num_pages}}
        if op == "clock":
            return {"t": time.perf_counter()}
        if op == "ping":
            return {}
        if op == "admit":
            return self._admit(msg["req"])
        if op == "step":
            return self._step()
        if op == "cancel":
            return {"cancelled": bool(
                self.engine.cancel(int(msg["rid"])))}
        if op == "handoff":
            reqs = self.engine.handoff()
            for r in reqs:
                self._reported.pop(r.request_id, None)
            return {"rids": [r.request_id for r in reqs]}
        if op == "take_migrations":
            return self._take_migrations()
        if op == "kv_import":
            return self._kv_import(msg["req"], msg.get("payload"))
        if op == "kv_release":
            return {"released": bool(
                self.engine.release_exported(int(msg["rid"])))}
        if op == "reset_gauges":
            self.engine.reset_gauges()
            if getattr(self.engine, "device", None) is not None:
                for w in _kernel_wrappers().values():
                    w.launches = 0
            # counters were reset in place: resend absolute values so
            # the parent's shadow follows (its federation watermark
            # banks the dip)
            self._sent_counters.clear()
            self._sent_hist_counts.clear()
            return {}
        if op == "audit":
            return self._audit()
        if op == "shutdown":
            return {}
        raise ValueError(f"unknown rpc op {op!r}")

    @staticmethod
    def _make_req(d):
        import numpy as np

        from .serving import ServedRequest
        req = ServedRequest(
            int(d["rid"]),
            np.asarray(d["prompt"], np.int32),
            int(d["max_new"]),
            d.get("eos"),
            priority=int(d.get("priority", 0)),
            ttft_deadline_s=d.get("ttft_deadline_s"),
            deadline_s=d.get("deadline_s"),
            tenant=d.get("tenant"))
        req.t_arrive = time.perf_counter() \
            - max(0.0, float(d.get("age_s", 0.0)))
        # replayed tokens (a respawn's re-admission): the engine's
        # requeue re-prefills prompt + emitted tokens through recompute,
        # so the stream goes on exactly where it was
        req.tokens = [int(t) for t in d.get("tokens", [])]
        req.preemptions = int(d.get("preemptions", 0))
        req.no_migrate = bool(d.get("no_migrate", False))
        return req

    def _admit(self, d):
        req = self._make_req(d)
        self.engine.requeue(req)
        self._reported[req.request_id] = [len(req.tokens), 0]
        return {}

    def _take_migrations(self):
        """Pop parked (request, KV payload) pairs in wire form. The reply
        cache keeps this exactly-once under retransmits; the parent
        mirrors the absolute token lists into its shadow before handing
        ownership to a decode replica."""
        from .disagg import kv_payload_to_wire
        out = []
        for req, payload in self.engine.take_migrations():
            self._reported.pop(req.request_id, None)
            out.append({"rid": req.request_id,
                        "tokens": [int(t) for t in req.tokens],
                        "t_first": req.t_first,
                        "preemptions": req.preemptions,
                        "payload": kv_payload_to_wire(payload)})
        return {"migrations": out}

    def _kv_import(self, d, wire_payload):
        """Admit a migrated request with its prefill KV: the engine seeds
        the pages into its prefix cache and requeues, so the attach is a
        full-length prefix hit (:mod:`.disagg`)."""
        from .disagg import kv_payload_from_wire
        req = self._make_req(d)
        res = self.engine.import_migration(
            req, kv_payload_from_wire(wire_payload or {}))
        self._reported[req.request_id] = [len(req.tokens), 0]
        return {"import": res}

    def _step(self):
        eng = self.engine
        finished = eng.step()
        updates = []
        live = [r for r in eng.slot_req if r is not None]
        live += [r for r in eng.queue]
        # parked migrations still report (the first token and the
        # migrate_out hop reach the parent's shadow before ownership
        # moves)
        migrating = [req for req, _ in
                     getattr(eng, "migrations_out", ())]
        live += migrating
        for req in live + list(finished):
            rep = self._reported.setdefault(req.request_id, [0, 0])
            toks = req.tokens[rep[0]:]
            hops = req.hops[rep[1]:]
            if not (toks or hops or req.finished):
                continue
            rep[0] += len(toks)
            rep[1] += len(hops)
            u = {"rid": req.request_id, "toks": [int(t) for t in toks],
                 "hops": [self._json_hop(h) for h in hops],
                 "preemptions": req.preemptions}
            if req.t_first:
                u["t_first"] = req.t_first
            if req.finished:
                u["finished"] = True
                u["reason"] = req.finish_reason
                u["t_done"] = req.t_done or time.perf_counter()
                if req.error is not None:
                    u["error"] = [type(req.error).__name__,
                                  str(req.error)[:300]]
                self._reported.pop(req.request_id, None)
            updates.append(u)
        body = {"done": [r.request_id for r in finished],
                "updates": updates,
                "queue": [r.request_id for r in eng.queue],
                "slots": [r.request_id if r is not None else None
                          for r in eng.slot_req],
                "migrating": [r.request_id for r in migrating],
                "rss": _rss_bytes()}
        body.update(self._metrics_diff())
        return body

    @staticmethod
    def _json_hop(h):
        out = {}
        for k, v in h.items():
            if isinstance(v, (str, int, float, bool)) or v is None:
                out[k] = v
            else:
                out[k] = repr(v)[:120]
        return out

    def _metrics_diff(self):
        """Registry snapshot diff: counters and gauges whose value moved
        since the last report (absolute values: the parent sets its
        shadow series; federation watermarks keep fleet totals
        monotonic), histograms re-shipped whole when their count moved
        (bounded by the reservoir capacity)."""
        from ..profiler.metrics import Counter, Gauge, Histogram
        reg = self.engine.metrics
        counters, gauges, hists = {}, {}, {}
        for name in reg.names():
            m = reg.get(name)
            if isinstance(m, Counter):
                v = m.value
                if self._sent_counters.get(name) != v:
                    self._sent_counters[name] = v
                    counters[name] = v
            elif isinstance(m, Histogram):
                if self._sent_hist_counts.get(name) != m.count:
                    self._sent_hist_counts[name] = m.count
                    hists[name] = {"count": m.count, "sum": m.sum,
                                   "min": m.min, "max": m.max,
                                   "samples": m.samples()}
            elif isinstance(m, Gauge):
                v = m.value
                key = "g:" + name
                if self._sent_counters.get(key) != v:
                    self._sent_counters[key] = v
                    gauges[name] = v
        out = {}
        if counters:
            out["counters"] = counters
        if gauges:
            out["gauges_m"] = gauges
        if hists:
            out["hists"] = hists
        out["gauges"] = {k: v for k, v in self.engine.gauges().items()
                         if isinstance(v, (int, float))}
        return out

    def _audit(self):
        """Page-accounting numbers for the parent's survivor audit (the
        zero-leak check across the process boundary, with the exported
        prefixes still pinned), the engine's forwards and the serving
        kernels' launches."""
        eng = self.engine
        free = len(eng._free_pages)
        prefix = getattr(eng, "prefix_cache_pages", 0)
        clean = (free + prefix == eng.num_pages - 1
                 and not eng._deferred_free
                 and all(not p for p in eng.slot_pages)
                 and all(not s for s in eng.slot_shared))
        out = {"clean": bool(clean), "free": free, "prefix": prefix,
               "num_pages": eng.num_pages,
               "pins": len(getattr(eng, "_exported_pins", ()))}
        if getattr(eng, "device", None) is not None:
            from ..ops.kernels import _build
            out["forwards"] = int(eng._stats["forwards"])
            out["launches"] = {n: int(w.launches)
                               for n, w in _kernel_wrappers().items()}
            # nvcc's output is kept only by the process that compiled:
            # empty when this worker loaded a library already built
            out["kernels_compiled"] = bool(_build.build_log())
        return out


def _heartbeat_loop(transport, interval_s, stop):
    while not stop.wait(interval_s):
        try:
            transport.send({"kind": "hb", "t": time.perf_counter()})
        except WireError:
            return


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fd", type=int, required=True)
    ap.add_argument("--hb-interval", type=float, default=0.2)
    args = ap.parse_args(argv)

    sock = socket.socket(fileno=args.fd)
    tr = WireTransport(sock, side="worker")
    stop = threading.Event()
    hb = threading.Thread(target=_heartbeat_loop,
                          args=(tr, args.hb_interval, stop),
                          name="worker-hb", daemon=True)
    hb.start()
    try:
        Worker(tr).serve()
    finally:
        stop.set()
        tr.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
