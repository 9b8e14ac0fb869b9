"""Speculative-decoding host-side state of the port: mode normalization and
the per-slot draft-length controller.

Copied from ``seldon_core_tpu/runtime/spec.py`` (the port imports nothing of
the JAX package, even where a module is jax-free): ``SPEC_MODES``, the
defaults, ``normalize_spec_mode`` and ``SpecController`` with the same EMA,
warm-up, floor, snapshot and lock discipline. ``SPEC_STATS_OFF`` is the
port's own: the one zero-valued stats dict of a server or batcher that does
not speculate.

The device half of speculation lives in
``servers/llmserver.LLMServer._get_spec_step`` (the fused draft+verify
program, a CUDA graph per batcher on the card) and ``runtime/batcher.py``
(dispatch/drain of variable-advance steps). The controller is pure
bookkeeping shared between the batcher loop (observe at drain, cap at
dispatch) and transport threads (``llm_stats`` snapshots at /metrics scrape
time), so every transition holds its lock.
"""

from __future__ import annotations

import threading
from typing import List

SPEC_MODES = ("off", "ngram", "draft")

# draft tokens per verify step when speculation is on and no explicit
# spec_k was configured (the verify forward is K+1 tokens wide: the last
# accepted token plus K drafts)
DEFAULT_SPEC_K = 4

# the speculation fields of ``llm_stats`` / ``ContinuousBatcher.spec_stats``
# when speculation is off (or no batcher exists yet)
SPEC_STATS_OFF = {"spec_mode": "off", "spec_k": 0, "spec_accept_rate": 0.0,
                  "spec_tokens_per_forward": 0.0, "spec_slot_steps_total": 0,
                  "spec_accept_rate_per_slot": [], "spec_draft_overhead_fraction": 0.0}

# longest n-gram the self-draft proposer tries to match in the slot's
# prompt+generated history (it falls through to shorter grams down to 1)
DEFAULT_SPEC_NGRAM = 3


def normalize_spec_mode(value) -> str:
    """Canonical spec_mode ("off", "ngram" or "draft"); raises ValueError on
    anything else so misconfiguration fails at load() time, not inside the
    batcher's dispatch loop."""
    v = str(value or "off").strip().lower()
    if v in ("off", "none", "no", "0", ""):
        return "off"
    if v in ("ngram", "n-gram", "prompt-lookup", "prompt_lookup", "self"):
        return "ngram"
    if v in ("draft", "draft-model", "draft_model", "model"):
        return "draft"
    raise ValueError(
        f"unknown spec_mode {value!r}: expected one of {SPEC_MODES}")


class SpecController:
    """Per-slot draft-length controller: adapts the number of draft tokens
    K offered to the verify step to the acceptance rate that slot has been
    observing, so a slot decoding un-draftable text stops paying for K
    rejected drafts per forward while a repetitive slot keeps the full
    depth.

    Every state transition happens under ``self._lock``: ``observe`` runs
    at the batcher loop's drain, ``cap`` at its dispatch, ``reset`` at
    admission, and ``rates``/``snapshot`` on transport threads at /metrics
    scrape time — an unlocked EMA update is a read-modify-write that loses
    observations when those threads interleave."""

    # EMA weight of the newest observation; small enough that one lucky
    # block does not whipsaw the cap, large enough to adapt within ~10
    # verify steps
    ALPHA = 0.3
    # verify steps a fresh slot runs at full depth before the controller
    # trusts its EMA (a single early rejection must not strand a
    # repetitive slot at cap 1)
    WARMUP_STEPS = 2

    def __init__(self, slots: int, k: int):
        self.S = int(slots)
        self.k = int(k)
        self._lock = threading.Lock()
        self._rate = [1.0] * self.S     # per-slot acceptance-rate EMA
        self._steps = [0] * self.S      # verify steps observed this occupancy
        self._accepted_total = 0        # drafts accepted, lifetime
        self._drafted_total = 0         # drafts offered, lifetime
        # per-slot verify steps, lifetime: one per ACTIVE SLOT per drained
        # verify forward (a forward covering 8 slots adds 8 — divide by
        # the active-slot count for the program count)
        self._slot_steps_total = 0
        self._tokens_total = 0          # tokens emitted by verify forwards

    def reset(self, slot: int) -> None:
        """New occupant: forget the previous request's acceptance history
        (its text is gone; its rate says nothing about the newcomer)."""
        with self._lock:
            self._rate[slot] = 1.0
            self._steps[slot] = 0

    def observe(self, slot: int, accepted_drafts: int, offered: int,
                tokens: int) -> None:
        """One drained verify step for ``slot``: ``accepted_drafts`` of
        ``offered`` draft tokens survived verification and the forward
        emitted ``tokens`` (accepted drafts + the corrected/bonus sample)."""
        with self._lock:
            self._slot_steps_total += 1
            self._tokens_total += int(tokens)
            self._accepted_total += int(accepted_drafts)
            self._drafted_total += int(offered)
            self._steps[slot] += 1
            if offered > 0:
                r = accepted_drafts / float(offered)
                self._rate[slot] += self.ALPHA * (r - self._rate[slot])

    def cap(self, slot: int) -> int:
        """Draft tokens to offer this slot on the next verify step. Full
        depth during warmup, then stepped down with the acceptance EMA.
        The floor is 1, NOT 0: a zero cap stops producing observations
        (nothing offered, nothing to accept), so the EMA could never
        recover when un-draftable text turns draftable — e.g. greedy
        decode falling into a cycle after a non-matching prompt. One
        probe draft per forward is the cheapest signal that keeps the
        controller live, and its reject costs a single wasted token
        column."""
        with self._lock:
            if self._steps[slot] < self.WARMUP_STEPS:
                return self.k
            r = self._rate[slot]
        if r >= 0.5:
            return self.k
        if r >= 0.2:
            return max(self.k // 2, 1)
        return 1

    def rates(self) -> List[float]:
        """Per-slot acceptance-rate EMA snapshot (one consistent read)."""
        with self._lock:
            return list(self._rate)

    def snapshot(self) -> dict:
        """Lifetime aggregates for llm_stats / the benches: draft
        acceptance rate, accepted tokens per target forward (the
        >1-token-per-cache-read multiplier speculation exists to buy),
        and the draft-overhead fraction — the share of verify-forward
        token columns (offered drafts + the always-computed base column)
        whose compute was wasted on drafts that lost verification."""
        with self._lock:
            drafted = self._drafted_total
            steps = self._slot_steps_total
            # every slot's share of a verify forward computes offered+1
            # token columns for that slot
            columns = drafted + steps
            return {
                "spec_accept_rate": (
                    self._accepted_total / drafted if drafted else 0.0),
                # per SLOT-step: a slot's KV is read once per verify
                # forward, so this is tokens per cache read for that slot
                "spec_tokens_per_forward": (
                    self._tokens_total / steps if steps else 0.0),
                "spec_draft_overhead_fraction": (
                    (drafted - self._accepted_total) / columns
                    if columns else 0.0),
                "spec_slot_steps_total": steps,
                "spec_accepted_drafts_total": self._accepted_total,
                "spec_drafted_total": drafted,
                "spec_tokens_total": self._tokens_total,
            }
