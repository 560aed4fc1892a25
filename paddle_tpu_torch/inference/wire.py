"""Length-prefixed JSON frame protocol for process-backed replicas: the
port of ``paddle_tpu/inference/wire.py``, byte for byte on the wire (a
frame one package encodes, the other decodes).

One parent (:class:`~paddle_tpu_torch.inference.proc_replica.ProcReplica`)
and one worker (``python -m paddle_tpu_torch.inference.worker``) speak
this protocol over a local ``socketpair``. The wire is treated as
hostile: frames carry a magic, an explicit length and a CRC32, every
payload is a JSON object with a strictly increasing per-direction
sequence number, and every way a frame can be wrong (truncated,
oversized, garbage bytes, bit-flipped, duplicated, reordered) surfaces
as a typed :class:`WireError` subclass, never a hang and never a
half-applied message. After a corrupt stretch the decoder resyncs by
scanning forward to the next magic, so one mangled frame costs one typed
error, not the connection.

Frame layout (all integers big-endian)::

    MAGIC(2) | length(4) | crc32(4) | payload = JSON utf-8

Fault hooks: :func:`add_fault_hook` registers a process-local callable
``hook(replica_id, direction, data) -> data | None`` consulted by
parent-side transports on every send (``direction="tx"``) and every
socket read (``"rx"``); returning ``None`` drops the bytes, returning
different bytes corrupts them, and sleeping inside the hook delays
them. The ``FaultInjector``'s ``drop_frame`` / ``delay_frame`` /
``corrupt_frame`` plans ride this seam, so the production code path
runs unmodified.

Standard library only: the worker boundary needs nothing the parent
cannot guarantee.
"""

from __future__ import annotations

import base64
import json
import select
import socket
import threading
import zlib

MAGIC = b"\xa5\x5a"
_HEADER = len(MAGIC) + 4 + 4
#: frames above this are a protocol violation (a corrupt length field
#: reads as a huge allocation request — reject, resync, move on).
#: Default only: both the decoder and the transport take ``max_frame``
#: as a constructor knob (KV-page transfers may size the cap to the page
#: geometry).
MAX_FRAME = 8 * 1024 * 1024

#: partial chunked-payload groups kept per transport while awaiting
#: their remaining chunks; beyond this the OLDEST group is discarded
#: (its sender's retransmit arrives under a fresh transfer id, so a
#: group orphaned by a corrupt chunk can never pin memory forever)
MAX_PARTIAL_CHUNK_GROUPS = 4


class WireError(RuntimeError):
    """Base of every typed wire failure (never raised bare)."""


class FrameCorrupt(WireError):
    """Bad magic, bad CRC, or a payload that is not a JSON object."""


class FrameTooLarge(WireError):
    """Length field exceeds ``MAX_FRAME`` — framing is lost."""


class FrameOutOfOrder(WireError):
    """Sequence number not strictly increasing (duplicate or replay)."""


class WireTimeout(WireError):
    """No complete frame within the caller's deadline."""


class WireClosed(WireError):
    """Peer EOF or a dead socket — the worker is gone."""


# ---- fault hooks (FaultInjector seam) --------------------------------------

_fault_hooks: list = []
_hooks_lock = threading.Lock()


def add_fault_hook(hook):
    """Register ``hook(replica_id, direction, data) -> data | None``
    (see module docstring). Returns the hook for ``remove``."""
    with _hooks_lock:
        _fault_hooks.append(hook)
    return hook


def remove_fault_hook(hook):
    with _hooks_lock:
        try:
            _fault_hooks.remove(hook)
        except ValueError:
            pass


def _apply_hooks(replica_id, direction, data):
    with _hooks_lock:
        hooks = list(_fault_hooks)
    for hook in hooks:
        if data is None:
            break
        data = hook(replica_id, direction, data)
    return data


# ---- framing ---------------------------------------------------------------

def encode_frame(obj, max_frame=MAX_FRAME) -> bytes:
    payload = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(payload) > max_frame:
        raise FrameTooLarge(
            f"payload {len(payload)} bytes exceeds frame cap "
            f"{max_frame}")
    return (MAGIC + len(payload).to_bytes(4, "big")
            + zlib.crc32(payload).to_bytes(4, "big") + payload)


class FrameDecoder:
    """Incremental decoder with resync. ``feed`` bytes in any
    chunking; ``next_frame`` yields one payload (bytes) or ``None``
    when more input is needed, raising a typed :class:`WireError` for
    each corrupt stretch AFTER advancing past it — the caller can keep
    calling and the next intact frame still decodes."""

    def __init__(self, max_frame=MAX_FRAME):
        self._buf = bytearray()
        self._max = int(max_frame)
        self.errors = 0

    def feed(self, data: bytes):
        self._buf += data

    def pending(self) -> int:
        return len(self._buf)

    def _resync(self, skip):
        """Drop ``skip`` bytes, then everything up to the next magic;
        returns how many bytes were discarded in total."""
        del self._buf[:skip]
        idx = self._buf.find(MAGIC)
        if idx < 0:
            # keep the last byte: it may be the first half of a magic
            # split across reads
            keep = 1 if self._buf[-1:] == MAGIC[:1] else 0
            dropped = skip + len(self._buf) - keep
            del self._buf[:len(self._buf) - keep]
            return dropped
        del self._buf[:idx]
        return skip + idx

    def next_frame(self):
        if len(self._buf) < _HEADER:
            if self._buf and not MAGIC.startswith(
                    bytes(self._buf[:2])):
                self.errors += 1
                n = self._resync(1)
                raise FrameCorrupt(f"bad magic ({n} bytes dropped)")
            return None
        if bytes(self._buf[:2]) != MAGIC:
            self.errors += 1
            n = self._resync(1)
            raise FrameCorrupt(f"bad magic ({n} bytes dropped)")
        length = int.from_bytes(self._buf[2:6], "big")
        if length > self._max:
            self.errors += 1
            self._resync(2)
            raise FrameTooLarge(
                f"frame length {length} exceeds {self._max}")
        if len(self._buf) < _HEADER + length:
            return None
        crc = int.from_bytes(self._buf[6:10], "big")
        payload = bytes(self._buf[_HEADER:_HEADER + length])
        if zlib.crc32(payload) != crc:
            self.errors += 1
            # the length field itself is untrusted after a CRC
            # mismatch: drop only the magic and rescan
            self._resync(2)
            raise FrameCorrupt("crc mismatch")
        del self._buf[:_HEADER + length]
        return payload


# ---- transport -------------------------------------------------------------

class WireTransport:
    """One socket endpoint: thread-safe framed ``send`` (the worker's
    heartbeat thread and RPC loop share one transport) and deadline-
    bounded ``recv``. ``side="parent"`` consults the fault hooks;
    the worker side never does (hooks are a parent-process test
    seam).

    Chunked payloads: a payload whose JSON encoding would
    overflow ``max_frame`` is transparently split into a multi-frame
    group — each chunk is an ordinary sequenced, CRC'd frame carrying
    a base64 slice plus ``{"_chunk": {"xid", "i", "n"}}`` — and
    :meth:`recv` reassembles the group before returning the decoded
    object. A corrupt chunk surfaces exactly like any corrupt frame
    (typed error, decoder resynced); the orphaned partial group is
    bounded by ``MAX_PARTIAL_CHUNK_GROUPS`` and the sender's
    retransmit arrives under a fresh transfer id, so chunking never
    adds a hang or a half-applied message to the fault model."""

    def __init__(self, sock, replica_id=None, side="parent",
                 max_frame=MAX_FRAME, chunk_bytes=None):
        self.sock = sock
        self.replica_id = replica_id
        self.side = side
        self.max_frame = int(max_frame)
        # raw-byte slice per chunk; sized so the b64 expansion (4/3)
        # plus the JSON envelope stays comfortably under the cap
        self.chunk_bytes = int(chunk_bytes) if chunk_bytes \
            else max(1, (self.max_frame // 2))
        self._dec = FrameDecoder(max_frame)
        self._send_lock = threading.Lock()
        self._send_seq = 0
        self._recv_seq = -1
        self._next_xid = 0
        self._partial = {}   # xid -> {"n": int, "parts": {i: bytes}}
        self._closed = False
        sock.setblocking(False)

    # -- send ----------------------------------------------------------

    def send(self, obj: dict):
        """Frame and send one JSON object (a ``seq`` is stamped in),
        transparently splitting into a chunked multi-frame group when
        the encoding would overflow the frame cap. Raises
        :class:`WireClosed` on a dead socket."""
        with self._send_lock:
            if self._closed:
                raise WireClosed("transport closed")
            payload = json.dumps(
                obj, separators=(",", ":")).encode("utf-8")
            # headroom for the seq stamp the single-frame path adds
            if len(payload) + 64 > self.max_frame:
                self._send_chunked(payload)
                return
            obj = dict(obj)
            obj["seq"] = self._send_seq
            self._send_seq += 1
            self._send_raw(encode_frame(obj, self.max_frame))

    def _send_chunked(self, payload: bytes):
        """Split ``payload`` (the un-stamped JSON bytes) into a
        multi-frame chunk group. Caller holds the send lock."""
        xid = self._next_xid
        self._next_xid += 1
        pieces = [payload[i:i + self.chunk_bytes]
                  for i in range(0, len(payload), self.chunk_bytes)]
        for i, piece in enumerate(pieces):
            frame = {"_chunk": {"xid": xid, "i": i,
                                "n": len(pieces)},
                     "d": base64.b64encode(piece).decode("ascii"),
                     "seq": self._send_seq}
            self._send_seq += 1
            self._send_raw(encode_frame(frame, self.max_frame))

    def _send_raw(self, data: bytes):
        if self.side == "parent":
            data = _apply_hooks(self.replica_id, "tx", data)
            if data is None:
                return               # dropped on the (injected) floor
        try:
            self._sendall(data)
        except (BrokenPipeError, ConnectionError, OSError) as e:
            raise WireClosed(f"send failed: {e}") from e

    def _sendall(self, data):
        # non-blocking socket: spin sendall by hand with short waits
        view = memoryview(data)
        while view:
            try:
                n = self.sock.send(view)
                view = view[n:]
            except BlockingIOError:
                select.select([], [self.sock], [], 0.5)

    # -- recv ----------------------------------------------------------

    def recv(self, timeout_s: float) -> dict:
        """One decoded, sequence-checked JSON object within
        ``timeout_s`` seconds. Raises :class:`WireTimeout`,
        :class:`WireClosed`, or a frame-level :class:`WireError`
        (after which the decoder has already resynced — call again)."""
        import time
        deadline = time.monotonic() + max(0.0, float(timeout_s))
        while True:
            payload = self._dec.next_frame()   # may raise (resynced)
            if payload is not None:
                obj = self._validate(payload)
                if "_chunk" in obj:
                    whole = self._absorb_chunk(obj)
                    if whole is None:
                        continue     # group incomplete — keep reading
                    return whole
                return obj
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise WireTimeout(
                    f"no frame within {timeout_s:.3f}s")
            try:
                r, _, _ = select.select([self.sock], [], [],
                                        min(remaining, 0.5))
            except (OSError, ValueError) as e:
                raise WireClosed(f"socket dead: {e}") from e
            if not r:
                continue
            try:
                data = self.sock.recv(65536)
            except BlockingIOError:
                continue
            except (ConnectionError, OSError) as e:
                raise WireClosed(f"recv failed: {e}") from e
            if not data:
                raise WireClosed("peer EOF")
            if self.side == "parent":
                data = _apply_hooks(self.replica_id, "rx", data)
                if data is None:
                    continue
            self._dec.feed(data)

    def _validate(self, payload):
        try:
            obj = json.loads(payload.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            raise FrameCorrupt(f"payload is not JSON: {e}") from e
        if not isinstance(obj, dict) or not isinstance(
                obj.get("seq"), int):
            raise FrameCorrupt("payload is not a sequenced object")
        seq = obj["seq"]
        if seq <= self._recv_seq:
            raise FrameOutOfOrder(
                f"seq {seq} after {self._recv_seq} (duplicate or "
                f"replayed frame)")
        self._recv_seq = seq
        return obj

    def _absorb_chunk(self, obj):
        """Fold one chunk frame into its partial group; returns the
        reassembled, decoded payload when the group completes, else
        ``None``. A malformed chunk envelope is a corrupt frame."""
        meta = obj.get("_chunk")
        try:
            xid, i, n = (int(meta["xid"]), int(meta["i"]),
                         int(meta["n"]))
            piece = base64.b64decode(obj["d"], validate=True)
        except (TypeError, KeyError, ValueError) as e:
            raise FrameCorrupt(f"bad chunk envelope: {e}") from e
        if n <= 0 or not (0 <= i < n):
            raise FrameCorrupt(f"bad chunk index {i}/{n}")
        group = self._partial.get(xid)
        if group is None:
            group = self._partial[xid] = {"n": n, "parts": {}}
            while len(self._partial) > MAX_PARTIAL_CHUNK_GROUPS:
                # oldest first — insertion order IS arrival order
                self._partial.pop(next(iter(self._partial)))
        if group["n"] != n:
            # two sizes claimed for one transfer id: framing is lying
            self._partial.pop(xid, None)
            raise FrameCorrupt(
                f"chunk group {xid} changed size {group['n']}->{n}")
        group["parts"][i] = piece
        if len(group["parts"]) < n:
            return None
        self._partial.pop(xid, None)
        whole = b"".join(group["parts"][k] for k in range(n))
        try:
            inner = json.loads(whole.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            raise FrameCorrupt(
                f"reassembled payload is not JSON: {e}") from e
        if not isinstance(inner, dict):
            raise FrameCorrupt("reassembled payload is not an object")
        # the group's last frame seq stands in for the whole payload
        # (chunk frames were individually sequence-checked already)
        inner.setdefault("seq", self._recv_seq)
        return inner

    @property
    def wire_errors(self) -> int:
        return self._dec.errors

    def close(self):
        with self._send_lock:
            self._closed = True
        try:
            self.sock.close()
        except OSError:
            pass


def socketpair():
    """A connected AF_UNIX pair (parent end, worker end)."""
    a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
    return a, b
