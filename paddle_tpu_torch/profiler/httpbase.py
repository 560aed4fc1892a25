"""The HTTP response skeleton the port's two standard-library servers
share: the observability exposition (``profiler/exposition.py``) and the
OpenAI-compatible API server (``inference/api_server.py``). The port of
``paddle_tpu/profiler/httpbase.py``.

- Materialize before send: every non-streaming body is encoded and
  measured (``Content-Length``) before its first byte leaves, so a
  client never reads a torn document.
- Guarded sections: :func:`evaluate_sections` evaluates each named
  ``/statusz`` provider in its own ``try``; a provider that raises
  becomes an ``{"error": ...}`` stanza and the document still parses.
"""

from __future__ import annotations

__all__ = ["REASONS", "evaluate_sections", "materialize_response",
           "http1_head", "http1_response"]

#: the status lines the two servers actually emit — a code outside
#: this table renders with a generic reason, never a KeyError
REASONS = {
    200: "OK",
    400: "Bad Request",
    404: "Not Found",
    405: "Method Not Allowed",
    429: "Too Many Requests",
    499: "Client Closed Request",
    500: "Internal Server Error",
    502: "Bad Gateway",
    503: "Service Unavailable",
    504: "Gateway Timeout",
}


def evaluate_sections(sections) -> dict:
    """Evaluate named section providers into one dict, each GUARDED —
    a provider raising mid-churn degrades to an ``{"error": ...}``
    stanza instead of tearing the document. The ONE loop behind the
    exposition ``/statusz`` render, ``ServingFleet.statusz()`` and the
    API server's ``/statusz``."""
    doc = {}
    for name, provider in dict(sections).items():
        try:
            doc[name] = provider()
        except Exception as exc:  # noqa: BLE001 — degrade per section
            doc[name] = {"error": f"{type(exc).__name__}: {exc}"}
    return doc


def materialize_response(code, body, ctype, extra_headers=()):
    """Encode + measure a response BEFORE anything is sent.

    Returns ``(code, headers, data)`` where ``headers`` is a list of
    ``(name, value)`` pairs starting with ``Content-Type`` and a
    ``Content-Length`` computed from the fully materialized ``data``
    bytes — the caller writes headers then ``data`` verbatim, so a
    handler exception can no longer tear a document mid-send."""
    data = body if isinstance(body, bytes) else str(body).encode("utf-8")
    headers = [("Content-Type", ctype),
               ("Content-Length", str(len(data)))]
    headers.extend(extra_headers)
    return code, headers, data


def http1_head(code, headers) -> bytes:
    """Serialize an HTTP/1.1 status line + header block (the raw-
    socket path: the asyncio API server owns its own framing)."""
    reason = REASONS.get(code, "Unknown")
    lines = [f"HTTP/1.1 {int(code)} {reason}"]
    lines.extend(f"{k}: {v}" for k, v in headers)
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


def http1_response(code, body, ctype, extra_headers=()) -> bytes:
    """One fully materialized HTTP/1.1 response (head + body bytes),
    ``Connection: close`` framing — the API server's non-streaming
    send path."""
    code, headers, data = materialize_response(code, body, ctype,
                                               extra_headers)
    headers.append(("Connection", "close"))
    return http1_head(code, headers) + data
