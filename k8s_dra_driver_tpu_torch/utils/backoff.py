"""Exponential backoff and client-side rate limiting.

Role of the reference's client-go flowcontrol: the QPS/burst token
bucket every API-server client carries (lengrongfu/k8s-dra-driver,
pkg/flags/kubeclient.go:49-64 — defaults QPS 5, burst 10) and the
transient-error retry delay its controllers use
(cmd/nvidia-dra-controller/imex.go:143-162). Pure stdlib, thread-safe.
"""

from __future__ import annotations

import random
import threading
import time


def full_jitter(delay: float, rng: random.Random | None = None) -> float:
    """AWS-style full jitter: uniform in [0, delay].

    The point is decorrelation: a node-wide apiserver blip makes every
    plugin's retry timer start at the same instant, and undithered
    exponential delays keep them in lockstep — each retry wave arrives as
    one thundering herd. Spreading each client uniformly over its window
    converts the spike into a flat trickle at the same average rate.
    """
    return (rng or _module_rng).uniform(0.0, delay)


_module_rng = random.Random()


class TokenBucket:
    """Blocking QPS/burst limiter (client-go flowcontrol analog).

    ``acquire()`` takes one token, sleeping until one accrues. Tokens
    refill continuously at ``qps`` up to ``burst``. A non-positive
    ``qps`` disables limiting entirely.
    """

    def __init__(self, qps: float = 5.0, burst: int = 10):
        if burst < 1:
            raise ValueError(f"burst must be >= 1, got {burst}")
        self.qps = qps
        self.burst = burst
        self._tokens = float(burst)
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def _refill(self, now: float) -> None:
        self._tokens = min(
            float(self.burst), self._tokens + (now - self._last) * self.qps
        )
        self._last = now

    def try_acquire(self) -> bool:
        """Non-blocking: take a token if one is available."""
        if self.qps <= 0:
            return True
        with self._lock:
            self._refill(time.monotonic())
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    def acquire(self) -> float:
        """Take a token, blocking as needed; returns seconds slept."""
        if self.qps <= 0:
            return 0.0
        slept = 0.0
        while True:
            with self._lock:
                self._refill(time.monotonic())
                if self._tokens >= 1.0:
                    self._tokens -= 1.0
                    return slept
                wait = (1.0 - self._tokens) / self.qps
            time.sleep(wait)
            slept += wait


class Backoff:
    """Exponential backoff with a cap; reset on success.

    The controller's transient-error retry (imex.go:143-162 waits a flat
    minute; exponential-with-cap subsumes that: short first retries for
    blips, the cap for real outages).

    ``jitter=True`` applies full jitter to each returned delay (the
    exponential base still grows deterministically, so ``current`` and the
    cap behave identically); pass ``rng`` to make jittered sequences
    reproducible in tests.
    """

    def __init__(
        self,
        initial: float = 1.0,
        cap: float = 60.0,
        factor: float = 2.0,
        jitter: bool = False,
        rng: random.Random | None = None,
    ):
        self.initial = initial
        self.cap = cap
        self.factor = factor
        self.jitter = jitter
        self._rng = rng
        self._current = 0.0

    def next_delay(self) -> float:
        """The delay to wait after one more consecutive failure."""
        if self._current <= 0:
            self._current = self.initial
        else:
            self._current = min(self.cap, self._current * self.factor)
        if self.jitter:
            return full_jitter(self._current, self._rng)
        return self._current

    def reset(self) -> None:
        self._current = 0.0

    @property
    def current(self) -> float:
        return self._current
