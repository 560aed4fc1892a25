"""Draft sources with known acceptance, for testing speculative decoding."""

from __future__ import annotations

import numpy as np

from ..inference.spec_decode import DraftSource

__all__ = ["OracleDraftSource"]


class OracleDraftSource(DraftSource):
    """Proposes each request's known continuation (request id -> tokens),
    shifted by ``shift`` mod ``vocab``: shift 0 drafts the plain stream
    (every draft accepted under greedy), shift 1 a wrong token at every
    position (every draft rejected)."""

    name = "oracle"

    def __init__(self, refs, vocab, shift=0):
        self.refs = refs
        self.vocab = int(vocab)
        self.shift = int(shift)

    def propose(self, eng, slots, k):
        drafts = np.zeros((eng.num_slots, k), np.int32)
        counts = np.zeros((eng.num_slots,), np.int32)
        for s in slots:
            req = eng.slot_req[s]
            t = self.refs[req.request_id][len(req.tokens):
                                          len(req.tokens) + k]
            drafts[s, :len(t)] = (np.asarray(t, np.int64) + self.shift) \
                % self.vocab
            counts[s] = len(t)
        return drafts, counts
