"""Admission / shedding policies: overload control at the release door.

The saturation grid (``saturation_{3,5,8}x``) shows why pure scheduling
loses at overload: the early-drop rule only fires once a request's
*remaining minimum* execution no longer fits its deadline, so under 5x
offered load most requests execute a few layers, age in a deep ready
queue, and are dropped mid-chain — the accelerators spend over half
their cycles on work that is then thrown away.  An admission policy
decides *at release time* whether a request enters the system at all;
a shed request is counted ``released`` + ``missed`` + ``dropped`` +
``shed`` (shedding never flatters the miss rate — it wins only by
letting the admitted requests actually complete on time).

Policies (call-spec strings, the same grid-axis shape as
``repro_torch.core.budget_online``):

* ``none`` — admit everything: bit-identical to the pre-admission
  simulator (pinned by ``tests/test_admission.py``).
* ``shed_early(margin=...)`` — admit iff the request could still meet
  its deadline after an estimated queueing wait: ``now + margin *
  backlog / n_acc + min_exec <= deadline``, where ``backlog`` is the
  total remaining minimum work of live admitted requests spread over
  the accelerators.  ``margin`` scales the wait estimate (0 degenerates
  to the early-drop test applied at the door).
* ``token_bucket(rate=...,burst=...)`` — a global token bucket caps the
  *admitted* rate near system capacity regardless of the offered rate;
  the queue stays shallow, so admitted requests complete instead of
  aging and being dropped mid-chain.

Determinism contract (both engines): admission decisions happen at
arrival events, which both engines process in the identical heap order,
so stateful policies (the token bucket) see the same decision sequence.
The backlog accumulator is maintained by the engines in INTEGER
nanoseconds — integer adds are associative, so the two engines'
differing drop *orders* (reference: ready-insertion order; SoA:
reverse-slot order) cannot produce divergent backlog floats.
"""

from __future__ import annotations

import inspect
from typing import TYPE_CHECKING, Union

if TYPE_CHECKING:  # annotation only
    from repro_torch.core.scheduler import Request


class AdmissionPolicy:
    """Per-release admit/shed decision.

    ``needs_backlog`` tells the engines to maintain the live-work
    accumulator (skipped entirely for policies that never read it, so
    ``none`` and ``token_bucket`` add no per-event work).  ``admit`` is
    invoked once per release, before the request enters the ready set;
    ``backlog_ns`` is the total remaining minimum execution time of
    admitted, not-yet-finished requests in integer nanoseconds, and
    ``min_work_s`` is this request's own total minimum execution time.
    ``bind(n_acc)`` is called once per run, after ``reset()``.
    """

    name = "none"
    needs_backlog = False

    def reset(self) -> None:
        """Clear cross-run state (instances may be reused across seeds)."""

    def bind(self, n_acc: int) -> None:
        self.n_acc = int(n_acc)

    def admit(
        self, req: "Request", now: float, backlog_ns: int, min_work_s: float
    ) -> bool:
        return True


class NoAdmission(AdmissionPolicy):
    """Admit everything — the pre-admission simulator, bit-identical."""

    name = "none"


class ShedEarlyAdmission(AdmissionPolicy):
    """Shed at the door when the estimated wait already dooms the request.

    The wait estimate is the admitted backlog (remaining minimum work of
    live requests) spread evenly over the accelerators, scaled by
    ``margin``.  With ``margin=0`` this degenerates to applying the
    early-drop test at release time (almost never sheds — the queue wait
    is what kills requests at saturation); larger margins shed earlier
    and keep the ready queue shallower.
    """

    name = "shed_early"
    needs_backlog = True

    def __init__(self, margin: float = 1.0):
        if margin < 0.0:
            raise ValueError(f"margin must be >= 0, got {margin}")
        self.margin = float(margin)

    def admit(
        self, req: "Request", now: float, backlog_ns: int, min_work_s: float
    ) -> bool:
        wait_est = self.margin * (backlog_ns * 1e-9) / self.n_acc
        return now + wait_est + min_work_s <= req.deadline_abs + 1e-12


class TokenBucketAdmission(AdmissionPolicy):
    """Global token bucket over all models: ``rate`` admissions/second
    sustained, bursts up to ``burst`` tokens.  The bucket starts full and
    refills continuously; an arrival that finds no whole token is shed.
    State updates only happen at arrival events, which both engines
    process in the identical order, so the float bucket state stays
    bit-identical across engines.
    """

    name = "token_bucket"

    def __init__(self, rate: float, burst: float = 8.0):
        if rate <= 0.0:
            raise ValueError(f"rate must be > 0 admissions/s, got {rate}")
        if burst < 1.0:
            raise ValueError(f"burst must be >= 1 token, got {burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self.reset()

    def reset(self) -> None:
        self._tokens = self.burst
        self._last = 0.0

    def admit(
        self, req: "Request", now: float, backlog_ns: int, min_work_s: float
    ) -> bool:
        dt = now - self._last
        if dt > 0.0:
            refill = self._tokens + dt * self.rate
            self._tokens = refill if refill < self.burst else self.burst
            self._last = now
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False


ADMISSION_POLICIES = {
    "none": NoAdmission,
    "shed_early": ShedEarlyAdmission,
    "token_bucket": TokenBucketAdmission,
}


def make_admission_policy(
    spec: Union[str, AdmissionPolicy, None]
) -> AdmissionPolicy:
    """Build an :class:`AdmissionPolicy` from a call-spec string.

    ``"none"``, ``"shed_early(margin=1.5)"``,
    ``"token_bucket(rate=100,burst=10)"`` ...; instances pass through
    unchanged and ``None`` means admit-everything (the pre-admission
    simulator, bit-identical).
    """
    from repro_torch.core.specs import parse_call_spec

    if spec is None:
        return NoAdmission()
    if isinstance(spec, AdmissionPolicy):
        return spec
    name, kwargs = parse_call_spec(spec)
    if name not in ADMISSION_POLICIES:
        raise KeyError(
            f"unknown admission policy '{name}' (have {sorted(ADMISSION_POLICIES)})"
        )
    cls = ADMISSION_POLICIES[name]
    try:
        return cls(**kwargs)
    except TypeError as e:
        params = sorted(set(inspect.signature(cls.__init__).parameters) - {"self"})
        raise ValueError(
            f"bad arguments for admission policy '{name}': {e}; "
            f"valid parameters: {params or 'none'}"
        ) from e
