"""Host-side draft proposal for speculative decoding.

The port of ``photon_tpu/serve/draft.py`` (pure host Python). A drafter
guesses the next K tokens of a slot's stream; the engine verifies all of
them (and the pending last token) in one mixed step
(``serve/cache.py::mixed_chunk_step`` with ``n_spec > 1``) and emits the
longest accepted prefix plus one model token. :class:`SpecController`
throttles the depth by the accept rate, down to plain decode.

The drafter is model-free: n-gram / prompt lookup over each slot's own
``prompt + generated`` history, strongest on templated traffic. All state
here belongs to the scheduler thread.
"""

from __future__ import annotations


class Drafter:
    """Per-slot draft proposal: :meth:`begin` at admission,
    :meth:`observe` after each emission burst, :meth:`end` at eviction.
    ``propose`` reads no device state; the verify step decides what is
    emitted."""

    def begin(self, slot: int, prompt: list[int]) -> None:
        raise NotImplementedError

    def observe(self, slot: int, tokens: list[int]) -> None:
        """``tokens`` were emitted (accepted + bonus) for ``slot``."""
        raise NotImplementedError

    def propose(self, slot: int, k: int) -> list[int]:
        """Up to ``k`` draft tokens continuing ``slot``'s stream (empty:
        the row rides the step as plain decode)."""
        raise NotImplementedError

    def end(self, slot: int) -> None:
        raise NotImplementedError


class NGramDrafter(Drafter):
    """Prompt lookup over each slot's history: for orders ``max_ngram ..
    min_ngram`` (longest first), find the context's trailing n-gram in an
    incremental index and propose what followed its most recent earlier
    occurrence. O(orders) dict probes per token."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1) -> None:
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got {min_ngram}/{max_ngram}"
            )
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self._ctx: dict[int, list[int]] = {}  # slot -> prompt + emitted
        #: slot -> {order -> {ngram -> (latest, previous) positions just past
        #: it}}: the trailing n-gram is its own latest occurrence, so the
        #: previous one keeps the continuation a repeating tail needs
        self._index: dict[int, dict[int, dict[tuple, tuple[int, int]]]] = {}

    def begin(self, slot: int, prompt: list[int]) -> None:
        self._ctx[slot] = []
        self._index[slot] = {n: {} for n in range(self.min_ngram, self.max_ngram + 1)}
        self._extend(slot, list(prompt))

    def observe(self, slot: int, tokens: list[int]) -> None:
        if slot in self._ctx:
            self._extend(slot, list(tokens))

    def end(self, slot: int) -> None:
        self._ctx.pop(slot, None)
        self._index.pop(slot, None)

    def _extend(self, slot: int, tokens: list[int]) -> None:
        ctx = self._ctx[slot]
        idx = self._index[slot]
        for tok in tokens:
            ctx.append(int(tok))
            end = len(ctx)
            for n in range(self.min_ngram, self.max_ngram + 1):
                if end >= n:
                    key = tuple(ctx[end - n:end])
                    prev = idx[n].get(key)
                    idx[n][key] = (end, prev[0] if prev else -1)

    def propose(self, slot: int, k: int) -> list[int]:
        """Guess one token at a time from ``ctx + draft so far``, so a
        period-``p`` repetition still gives a full-depth draft."""
        ctx = self._ctx.get(slot)
        if ctx is None or k < 1:
            return []
        idx = self._index[slot]
        out: list[int] = []
        while len(out) < k:
            tok = self._guess_next(ctx, out, idx)
            if tok is None:
                break
            out.append(tok)
        return out

    def _guess_next(self, ctx: list[int], out: list[int],
                    idx: dict[int, dict[tuple, tuple[int, int]]]) -> int | None:
        tail = ctx[-self.max_ngram:] + out if out else ctx
        end = len(ctx) + len(out)
        for n in range(self.max_ngram, self.min_ngram - 1, -1):
            if end < n:
                continue
            hit = idx[n].get(tuple(tail[-n:]))
            if hit is None:
                continue
            # a continuation must lie inside ctx: the trailing gram's own
            # latest occurrence has none yet
            pos = hit[0] if hit[0] < len(ctx) else hit[1]
            if 0 <= pos < len(ctx):
                return ctx[pos]
        return None


class SpecController:
    """Accept-rate EWMA → draft depth. At or over ``accept_floor`` the
    depth is ``round(ewma * k_max)`` (at least 1); under it, 0 (plain
    decode), except one single-token probe every ``probe_ticks`` steps
    (0 = never). The EWMA starts at 1.0, so drafting engages at once."""

    def __init__(self, k_max: int, accept_floor: float = 0.3,
                 ewma_alpha: float = 0.2, probe_ticks: int = 64) -> None:
        if k_max < 1:
            raise ValueError(f"need k_max >= 1, got {k_max}")
        self.k_max = k_max
        self.accept_floor = accept_floor
        self.ewma_alpha = ewma_alpha
        self.probe_ticks = probe_ticks
        self.ewma = 1.0
        self.drafted = 0
        self.accepted = 0
        self.spec_steps = 0
        self._ticks_throttled = 0

    def set_k_max(self, k_max: int) -> None:
        """A new depth ceiling at run time; 0 turns drafting off, probes
        included. A negative value raises."""
        k = int(k_max)
        if k < 0:
            raise ValueError(f"set_k_max needs k_max >= 0 (0 = off), got {k_max}")
        self.k_max = k

    def k_effective(self) -> int:
        """The current depth, without advancing the probe clock."""
        if self.k_max and self.ewma >= self.accept_floor:
            return max(1, min(self.k_max, round(self.ewma * self.k_max)))
        return 0

    def next_k(self) -> int:
        """The next step's depth; call once per step phase (it advances
        the probe clock while throttled off)."""
        k = self.k_effective()
        if k:
            self._ticks_throttled = 0
            return k
        self._ticks_throttled += 1
        if self.probe_ticks and self._ticks_throttled >= self.probe_ticks:
            self._ticks_throttled = 0
            return min(1, self.k_max)
        return 0

    def observe(self, drafted: int, accepted: int) -> None:
        """Fold one drafted step's counts into the EWMA (a step without
        drafts leaves it)."""
        if drafted < 1:
            return
        self.drafted += drafted
        self.accepted += accepted
        self.spec_steps += 1
        self.ewma += self.ewma_alpha * (accepted / drafted - self.ewma)
