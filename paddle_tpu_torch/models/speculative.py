"""Draft proposers for speculative decoding through the ragged kernel.

A copy of ``paddle_tpu/models/speculative.py`` (numpy only).

The continuous-batching engine (models/serving.py) verifies K draft
tokens per decode row as ONE q_len=K+1 ragged row — a prefill-chunk
shape the step executable already handles. Proposers only have to be
cheap and schedule-independent: a proposal may depend ONLY on the
request's own committed tokens (prompt + out_tokens), never on batch
composition, so byte-identical replay and the schedule-independence
suite keep holding with speculation on.

`NGramProposer` is the model-free self-draft (vLLM's "ngram" method,
also the Gemma-on-TPU serving paper's cheap baseline): match the
trailing n-gram against its most recent earlier occurrence in the
request's own token history and propose the continuation that followed
it. Repetitive stretches — code, templated text, greedy cycles —
verify at high acceptance; novel text degrades to plain decode (the
verify row still emits its one guaranteed token).

A small-model draft plugs in behind the same two-method interface.
"""

from __future__ import annotations

import numpy as np

__all__ = ["DraftProposer", "NGramProposer"]


class DraftProposer:
    """Interface: propose(tokens, k) -> up-to-k draft tokens (int32).

    `tokens` is the request's committed history (prompt + generated so
    far, the last entry being the token about to be fed to the model).
    Implementations MUST be a pure function of `tokens` — no batch
    state, no RNG — so speculative output stays schedule-independent."""

    def propose(self, tokens: np.ndarray, k: int) -> np.ndarray:
        raise NotImplementedError

    def signature(self) -> str:
        """Stable identity for logging/meta (not used in cache keys:
        acceptance is exact-match, so outputs never depend on it)."""
        return type(self).__name__


class NGramProposer(DraftProposer):
    """Greedy n-gram self-draft: longest-suffix match, copy what
    followed. `max_n` bounds the matched suffix (longer matches are
    tried first — they extrapolate better), `window` bounds the scan
    to the most recent tokens so per-row host cost stays O(window)."""

    def __init__(self, max_n: int = 3, window: int = 512):
        if max_n < 1:
            raise ValueError(f"max_n must be >= 1 (got {max_n})")
        self.max_n = max_n
        self.window = window

    def signature(self) -> str:
        return f"ngram(max_n={self.max_n},window={self.window})"

    def propose(self, tokens: np.ndarray, k: int) -> np.ndarray:
        toks = np.asarray(tokens, np.int32).reshape(-1)
        L = len(toks)
        if k <= 0 or L < 2:
            return np.empty((0,), np.int32)
        lo = max(0, L - self.window)
        for n in range(min(self.max_n, L - 1), 0, -1):
            tail = toks[L - n:]
            # candidate match ends (exclusive) strictly before the tail
            # itself; scan newest-first so loops resume where they left
            hay = toks[lo:L - 1]
            if len(hay) < n:
                continue
            win = np.lib.stride_tricks.sliding_window_view(hay, n)
            hits = np.nonzero((win == tail).all(axis=1))[0]
            if len(hits) == 0:
                continue
            start = lo + int(hits[-1]) + n   # first token AFTER the match
            return toks[start:start + k].copy()
        return np.empty((0,), np.int32)
