"""The port's wire protocol (paddle_tpu_torch.inference.wire) against
the JAX package's: the twenty cases of tests/test_wire.py run against
the port's module (framing, resync after garbage, crc damage, frames too
large, order, timeouts, closing, chunked sends past the frame cap, the
partial-chunk bound, the fault hooks and both fuzz sweeps), then the two
packages against each other: the same objects encode to the same bytes,
each package decodes the other's frames and chunk groups, and a JAX
transport and a port transport hold a conversation over one socketpair.
Exact; there is no tolerance."""

import json
import threading
import zlib

import pytest

from paddle_tpu.inference import wire as jwire
from paddle_tpu_torch.inference import wire as twire
from paddle_tpu_torch.inference.wire import (MAGIC, MAX_FRAME, FrameCorrupt,
                                             FrameDecoder, FrameOutOfOrder,
                                             FrameTooLarge, WireClosed,
                                             WireError, WireTimeout,
                                             WireTransport, add_fault_hook,
                                             encode_frame,
                                             remove_fault_hook, socketpair)

pytestmark = pytest.mark.proc_fleet


def _drain(dec):
    """Decode everything buffered: (payloads, typed errors)."""
    out, errs = [], []
    while True:
        try:
            p = dec.next_frame()
        except WireError as e:
            errs.append(e)
            continue
        if p is None:
            return out, errs
        out.append(json.loads(p.decode()))


# ---- framing ---------------------------------------------------------------

def test_roundtrip_single_and_chunked():
    msgs = [{"seq": i, "op": "step", "i": i} for i in range(5)]
    blob = b"".join(encode_frame(m) for m in msgs)
    dec = FrameDecoder()
    # worst-case chunking: one byte at a time
    got = []
    for b in blob:
        dec.feed(bytes([b]))
        while True:
            p = dec.next_frame()
            if p is None:
                break
            got.append(json.loads(p.decode()))
    assert got == msgs
    assert dec.errors == 0
    assert dec.pending() == 0


def test_truncated_frame_waits_then_completes():
    frame = encode_frame({"seq": 0, "x": "y" * 100})
    dec = FrameDecoder()
    dec.feed(frame[:30])
    assert dec.next_frame() is None       # incomplete: wait, not error
    dec.feed(frame[30:])
    assert json.loads(dec.next_frame().decode())["x"] == "y" * 100


def test_oversized_length_is_typed_and_resyncs():
    huge = MAGIC + (MAX_FRAME + 1).to_bytes(4, "big") + b"\0" * 8
    good = encode_frame({"seq": 1})
    dec = FrameDecoder()
    dec.feed(huge + good)
    with pytest.raises(FrameTooLarge):
        dec.next_frame()
    out, errs = _drain(dec)
    assert [m["seq"] for m in out] == [1]
    assert not errs


def test_crc_mismatch_is_typed_and_resyncs():
    bad = bytearray(encode_frame({"seq": 0, "body": "payload"}))
    bad[-3] ^= 0xFF                      # flip a payload byte
    good = encode_frame({"seq": 1})
    dec = FrameDecoder()
    dec.feed(bytes(bad) + good)
    with pytest.raises(FrameCorrupt):
        dec.next_frame()
    out, errs = _drain(dec)
    assert [m["seq"] for m in out] == [1]


def test_garbage_prefix_resyncs_to_frame():
    good = encode_frame({"seq": 0, "ok": True})
    dec = FrameDecoder()
    dec.feed(b"\x00\x01\x02 not a frame at all " + good)
    errs = 0
    got = []
    for _ in range(50):
        try:
            p = dec.next_frame()
        except WireError:
            errs += 1
            continue
        if p is None:
            break
        got.append(json.loads(p.decode()))
    assert errs >= 1
    assert got and got[0]["ok"] is True


def test_split_magic_across_reads():
    good = encode_frame({"seq": 0})
    dec = FrameDecoder()
    dec.feed(b"junk" + good[:1])         # first magic byte only
    try:
        dec.next_frame()
    except WireError:
        pass
    dec.feed(good[1:])
    out, errs = _drain(dec)
    assert [m["seq"] for m in out] == [0]


def test_payload_not_json_is_typed():
    payload = b"\xffnot json"
    raw = (MAGIC + len(payload).to_bytes(4, "big")
           + zlib.crc32(payload).to_bytes(4, "big") + payload)
    a, b = socketpair()
    try:
        tr = WireTransport(a, side="worker")
        b.sendall(raw)
        with pytest.raises(FrameCorrupt):
            tr.recv(0.5)
    finally:
        a.close()
        b.close()


# ---- transport sequencing --------------------------------------------------

def test_duplicate_frame_is_out_of_order():
    a, b = socketpair()
    try:
        tr = WireTransport(a, side="worker")
        frame = encode_frame({"seq": 0, "op": "ping"})
        b.sendall(frame + frame)          # exact duplicate
        assert tr.recv(0.5)["op"] == "ping"
        with pytest.raises(FrameOutOfOrder):
            tr.recv(0.5)
    finally:
        a.close()
        b.close()


def test_recv_timeout_is_typed_not_hang():
    a, b = socketpair()
    try:
        tr = WireTransport(a, side="worker")
        with pytest.raises(WireTimeout):
            tr.recv(0.05)
    finally:
        a.close()
        b.close()


def test_peer_eof_is_wire_closed():
    a, b = socketpair()
    try:
        tr = WireTransport(a, side="worker")
        b.close()
        with pytest.raises(WireClosed):
            tr.recv(0.5)
    finally:
        a.close()


def test_transport_roundtrip_threads():
    a, b = socketpair()
    ta = WireTransport(a, side="worker")
    tb = WireTransport(b, side="worker")
    try:
        def pump():
            for i in range(20):
                ta.send({"kind": "rpc", "i": i})
        t = threading.Thread(target=pump)
        t.start()
        got = [tb.recv(1.0)["i"] for _ in range(20)]
        t.join()
        assert got == list(range(20))     # ordered, none lost
    finally:
        ta.close()
        tb.close()


def test_parent_side_fault_hooks_fire():
    a, b = socketpair()
    ta = WireTransport(a, replica_id=7, side="parent")
    tb = WireTransport(b, side="worker")
    seen = []

    def hook(rid, direction, data):
        seen.append((rid, direction))
        return data

    add_fault_hook(hook)
    try:
        ta.send({"op": "ping"})
        assert tb.recv(0.5)["op"] == "ping"
        tb.send({"op": "pong"})
        assert ta.recv(0.5)["op"] == "pong"
    finally:
        remove_fault_hook(hook)
        ta.close()
        tb.close()
    assert (7, "tx") in seen and (7, "rx") in seen


def test_worker_side_never_consults_hooks():
    a, b = socketpair()
    ta = WireTransport(a, side="worker")
    tb = WireTransport(b, side="worker")

    def drop_all(rid, direction, data):
        return None

    add_fault_hook(drop_all)
    try:
        ta.send({"op": "ping"})
        assert tb.recv(0.5)["op"] == "ping"
    finally:
        remove_fault_hook(drop_all)
        ta.close()
        tb.close()


# ---- chunked multi-frame payloads ------------------------------------------

def test_frame_cap_is_a_knob():
    small = 256
    with pytest.raises(FrameTooLarge):
        encode_frame({"blob": "x" * 300}, max_frame=small)
    # the same payload passes under the default cap
    assert encode_frame({"blob": "x" * 300})


def test_oversized_payload_round_trips_chunked():
    a, b = socketpair()
    ta = WireTransport(a, side="worker", max_frame=512)
    tb = WireTransport(b, side="worker", max_frame=512)
    try:
        msg = {"op": "kv_page", "data": "p" * 4000}
        ta.send(msg)                       # > cap: must chunk
        got = tb.recv(2.0)
        assert got["op"] == "kv_page" and got["data"] == msg["data"]
        # plain traffic still flows on the same transport after it
        ta.send({"op": "ping"})
        assert tb.recv(1.0)["op"] == "ping"
    finally:
        ta.close()
        tb.close()


def test_chunked_and_plain_interleave_both_directions():
    a, b = socketpair()
    ta = WireTransport(a, side="worker", max_frame=400,
                       chunk_bytes=64)
    tb = WireTransport(b, side="worker", max_frame=400,
                       chunk_bytes=64)
    try:
        for i in range(6):
            ta.send({"i": i, "data": "z" * (900 if i % 2 else 4)})
        got = [tb.recv(2.0) for _ in range(6)]
        assert [g["i"] for g in got] == list(range(6))
        tb.send({"back": True, "data": "q" * 1200})
        assert ta.recv(2.0)["back"] is True
    finally:
        ta.close()
        tb.close()


def test_corrupt_chunk_is_typed_and_retransmit_succeeds():
    """One mangled chunk mid-group: a typed error, the partial group
    is orphaned (bounded), and a full retransmit under a fresh
    transfer id reassembles cleanly — resumability at the message
    level, exactly the shape the kv_transfer RPC layer leans on."""
    a, b = socketpair()
    ta = WireTransport(a, replica_id=3, side="parent", max_frame=512,
                       chunk_bytes=96)
    tb = WireTransport(b, side="worker", max_frame=512,
                       chunk_bytes=96)
    state = {"n": 0}

    def corrupt_second_tx(rid, direction, data):
        if direction != "tx" or data is None:
            return data
        state["n"] += 1
        if state["n"] == 2:                # second chunk frame only
            buf = bytearray(data)
            buf[len(buf) // 2] ^= 0xFF
            return bytes(buf)
        return data

    add_fault_hook(corrupt_second_tx)
    try:
        msg = {"op": "kv_page", "payload": "k" * 800}
        ta.send(msg)
        saw_error = False
        got = None
        for _ in range(8):
            try:
                got = tb.recv(0.3)
                break
            except WireTimeout:
                break
            except WireError:
                saw_error = True
        assert saw_error and got is None   # typed, not half-applied
        remove_fault_hook(corrupt_second_tx)
        ta.send(msg)                       # retransmit, fresh xid
        got = tb.recv(2.0)
        assert got["payload"] == msg["payload"]
    finally:
        remove_fault_hook(corrupt_second_tx)
        ta.close()
        tb.close()


def test_partial_chunk_groups_are_bounded():
    from paddle_tpu_torch.inference.wire import MAX_PARTIAL_CHUNK_GROUPS
    a, b = socketpair()
    tb = WireTransport(b, side="worker", max_frame=512)
    try:
        # hand-craft first-of-two chunks for many transfer ids
        import base64
        seq = 0
        for xid in range(MAX_PARTIAL_CHUNK_GROUPS + 3):
            frame = {"_chunk": {"xid": xid, "i": 0, "n": 2},
                     "d": base64.b64encode(b"half").decode(),
                     "seq": seq}
            seq += 1
            a.sendall(encode_frame(frame))
        with pytest.raises(WireTimeout):
            tb.recv(0.2)                   # nothing ever completes
        assert len(tb._partial) <= MAX_PARTIAL_CHUNK_GROUPS
    finally:
        a.close()
        tb.close()


def test_fuzz_chunked_transport_never_hangs_never_half_applies():
    """Chunked extension of the fuzz satellite: large payloads split
    into multi-frame groups ride a wire that randomly bit-flips raw
    bytes. Receiver contract: every reassembled payload is identical
    to a sent one (never stitched from damaged pieces), damage
    surfaces as typed errors, and a bounded number of retransmits
    always lands the payload — no hang, no half-apply."""
    import random
    rng = random.Random(0xD15A66)
    for trial in range(8):
        a, b = socketpair()
        ta = WireTransport(a, side="worker", max_frame=384,
                           chunk_bytes=rng.choice((48, 64, 96)))
        tb = WireTransport(b, side="worker", max_frame=384,
                           chunk_bytes=64)
        try:
            sent = {"trial": trial,
                    "blob": "".join(rng.choice("abcdef")
                                    for _ in range(
                                        rng.randint(600, 2400)))}
            delivered = None
            for attempt in range(6):
                # corrupt one raw byte of the encoded stream half the
                # time by re-sending through a mangling proxy pair
                damage = rng.random() < 0.5 and attempt < 5
                if not damage:
                    ta.send(sent)
                else:
                    payload = json.dumps(
                        sent, separators=(",", ":")).encode()
                    pieces = [payload[i:i + ta.chunk_bytes]
                              for i in range(0, len(payload),
                                             ta.chunk_bytes)]
                    import base64 as b64
                    xid = ta._next_xid
                    ta._next_xid += 1
                    raw = b""
                    for i, piece in enumerate(pieces):
                        fr = {"_chunk": {"xid": xid, "i": i,
                                         "n": len(pieces)},
                              "d": b64.b64encode(piece).decode(),
                              "seq": ta._send_seq}
                        ta._send_seq += 1
                        raw += encode_frame(fr, ta.max_frame)
                    buf = bytearray(raw)
                    buf[rng.randrange(len(buf))] ^= (
                        1 << rng.randrange(8))
                    a.sendall(bytes(buf))
                # drain until this attempt resolves
                for _ in range(64):
                    try:
                        got = tb.recv(0.25)
                    except WireTimeout:
                        break
                    except WireError:
                        continue           # typed — resync + go on
                    assert got["blob"] == sent["blob"], \
                        "half-applied reassembly"
                    delivered = got
                    break
                if delivered:
                    break
            assert delivered is not None, trial
        finally:
            ta.close()
            tb.close()


# ---- the fuzz satellite ----------------------------------------------------

def test_fuzz_decoder_never_hangs_never_half_applies():
    """Seeded fuzz: a stream of intact frames interleaved with
    truncated / oversized / garbage / duplicated / bit-flipped
    material, fed in random chunk sizes. The decoder contract under
    fire: (a) bounded work per byte — never a hang; (b) at least one
    typed WireError per damaged trial; (c) nothing half-applied —
    every decoded payload is byte-identical to an intact sent frame
    (CRC guarantee); (d) every intact frame BEFORE the first damage
    decodes (a corrupt length field may legitimately hold followers
    in its pending window until more bytes arrive — the transport's
    deadline + retransmit layer owns that case, and
    test_transport_roundtrip_threads/test_corrupt_frame tests in
    test_proc_replica.py pin it end to end)."""
    import random
    rng = random.Random(0xC0FFEE)
    for trial in range(20):
        frames = []     # (bytes, payload | None, is_damage)
        seq = 0
        for _ in range(rng.randint(5, 25)):
            kind = rng.choice(["ok", "ok", "ok", "garbage",
                               "truncated", "oversized", "flipped",
                               "duplicate"])
            msg = {"seq": seq, "op": "step",
                   "blob": "x" * rng.randint(0, 200)}
            raw = encode_frame(msg)
            if kind == "ok":
                frames.append((raw, msg, False))
                seq += 1
            elif kind == "garbage":
                frames.append((bytes(rng.getrandbits(8)
                                     for _ in range(
                                         rng.randint(1, 64))),
                               None, True))
            elif kind == "truncated":
                cut = rng.randint(1, max(2, len(raw) - 1))
                frames.append((raw[:cut], None, True))
            elif kind == "oversized":
                frames.append(
                    (MAGIC + (MAX_FRAME + rng.randint(1, 999))
                     .to_bytes(4, "big") + b"\0" * 8, None, True))
            elif kind == "flipped":
                buf = bytearray(raw)
                buf[rng.randrange(len(buf))] ^= (
                    1 << rng.randrange(8))
                frames.append((bytes(buf), None, True))
            else:                         # duplicate of a frame
                frames.append((raw, msg, False))
                frames.append((raw, None, False))
                seq += 1
        blob = b"".join(f for f, _, _ in frames)
        prefix_expected = []
        for _, m, damaged_f in frames:
            if damaged_f:
                break
            if m is not None:
                prefix_expected.append(m)
        any_damage = any(d for _, _, d in frames)

        dec = FrameDecoder()
        got, errors = [], 0
        i = 0
        budget = len(blob) * 4 + 1000     # hard progress bound
        while i < len(blob) or dec.pending():
            if i < len(blob):
                n = rng.randint(1, 97)
                dec.feed(blob[i:i + n])
                i += n
            while True:
                budget -= 1
                assert budget > 0, "decoder stopped making progress"
                try:
                    p = dec.next_frame()
                except WireError:
                    errors += 1
                    continue
                if p is None:
                    break
                got.append(json.loads(p.decode()))
            if i >= len(blob):
                break
        for m in prefix_expected:
            assert m in got, (trial, m["seq"])
        if not any_damage:
            sent = [m for _, m, _ in frames if m is not None]
            assert got == sent, trial
        else:
            assert errors >= 1, trial
        # nothing half-applied: only byte-identical intact payloads
        sent_raw = {json.dumps(m, separators=(",", ":"))
                    for _, m, _ in frames if m is not None}
        for g in got:
            assert json.dumps(g, separators=(",", ":")) in sent_raw


# ---- the two packages against each other -----------------------------------

_OBJS = [{"seq": 0}, {"seq": 7, "op": "step", "i": [1, 2, 3]},
         {"kind": "reply", "id": 3, "x": 1.5, "s": "\u00e9\u4e2d",
          "n": None, "b": True, "seq": 12},
         {"seq": 1, "blob": "y" * 5000, "nested": {"a": [{"b": -1}]}}]


@pytest.mark.parametrize("obj", _OBJS, ids=["empty", "list", "types",
                                             "nested"])
def test_frames_are_byte_equal_to_the_jax_packages(obj):
    assert twire.encode_frame(obj) == jwire.encode_frame(obj)
    assert twire.MAGIC == jwire.MAGIC and twire.MAX_FRAME == jwire.MAX_FRAME
    assert twire.MAX_PARTIAL_CHUNK_GROUPS == jwire.MAX_PARTIAL_CHUNK_GROUPS
    with pytest.raises(twire.FrameTooLarge):
        twire.encode_frame({"blob": "x" * 300}, max_frame=256)


def test_each_package_decodes_the_others_frames():
    msgs = [{"seq": i, "op": "step", "blob": "z" * (i * 37)}
            for i in range(6)]
    for enc, dec_mod in ((jwire, twire), (twire, jwire)):
        dec = dec_mod.FrameDecoder()
        blob = b"junk" + b"".join(enc.encode_frame(m) for m in msgs)
        got, errs = [], 0
        dec.feed(blob)
        while True:
            try:
                p = dec.next_frame()
            except dec_mod.WireError:
                errs += 1
                continue
            if p is None:
                break
            got.append(json.loads(p.decode()))
        assert got == msgs and errs == 1


@pytest.mark.parametrize("sender", ["jax", "torch"])
def test_chunked_groups_cross_between_packages(sender):
    """A payload past the frame cap, split by one package's transport,
    is reassembled by the other's; plain traffic flows on after it, in
    both directions, and the chunk frames on the wire are the same
    bytes either package sends."""
    mods = {"jax": jwire, "torch": twire}
    other = "torch" if sender == "jax" else "jax"
    a, b = socketpair()
    ta = mods[sender].WireTransport(a, side="worker", max_frame=512,
                                    chunk_bytes=96)
    tb = mods[other].WireTransport(b, side="worker", max_frame=512,
                                   chunk_bytes=96)
    try:
        msg = {"op": "kv_import", "payload": "k" * 3000}
        ta.send(msg)
        got = tb.recv(2.0)
        assert got["op"] == "kv_import" and got["payload"] == msg["payload"]
        ta.send({"op": "ping"})
        assert tb.recv(1.0)["op"] == "ping"
        tb.send({"back": True, "data": "q" * 1200})
        assert ta.recv(2.0)["back"] is True
    finally:
        ta.close()
        tb.close()
    # the chunk frames themselves: each package's bytes for one payload
    frames = {}
    for name, mod in mods.items():
        x, y = socketpair()
        tr = mod.WireTransport(x, side="worker", max_frame=512,
                               chunk_bytes=96)
        try:
            tr.send({"op": "kv_import", "payload": "k" * 3000})
            y.setblocking(False)
            buf = b""
            while True:
                try:
                    part = y.recv(1 << 16)
                except BlockingIOError:
                    break
                if not part:
                    break
                buf += part
            frames[name] = buf
        finally:
            tr.close()
            y.close()
    assert frames["jax"] == frames["torch"] and len(frames["jax"]) > 3000


def test_port_hooks_are_the_ports_own():
    """A hook registered on one package's wire never sees the other
    package's transports (each process-local registry is its own)."""
    seen = []

    def hook(rid, direction, data):
        seen.append(direction)
        return data

    jwire.add_fault_hook(hook)
    a, b = socketpair()
    ta = WireTransport(a, replica_id=1, side="parent")
    tb = WireTransport(b, side="worker")
    try:
        ta.send({"op": "ping"})
        assert tb.recv(0.5)["op"] == "ping"
    finally:
        jwire.remove_fault_hook(hook)
        ta.close()
        tb.close()
    assert seen == []
