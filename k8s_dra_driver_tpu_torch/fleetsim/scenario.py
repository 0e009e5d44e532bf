"""Scenario specs for the deterministic fleet soak (fleetsim/).

A :class:`ScenarioSpec` is the soak's whole input: the diurnal load
curve per tenant class, one flash crowd on a shared prefix, the chaos
timeline (chip unplugs/flaps, an apiserver blackout, the gang arrival
that strands on fragmentation), the fixed chip-role layout, every
policy knob the real subsystems take, and the gate budgets the run is
judged against. Everything is expressed in VIRTUAL seconds on the
soak's shared clock; chaos instants are fractions of the duration so
the same scenario shape scales from the minutes-long smoke profile
down to the mini profile the tests and ``chip_smoke.py`` run.

Determinism contract: given the same spec (seed included), the harness
replays bit-identically — arrivals are seeded Poisson draws
(:func:`poisson_draw`, Knuth's product method), prompts come from
:func:`build_class_prompts`' seeded streams, and nothing in this module
reads the wall clock.

The default chip-role layout (``8x1x1``, chips ``tpu-0``..``tpu-7``)
is chosen so every axis has a deterministic place to land:

- chips 0,1 — the elastic training gang (shrinks/grows on chip health);
- chip 2 — two ProcessShared co-tenants the rebalancer arbitrates;
- chips 4,6 — the pinned serving replicas (``min_replicas`` floor);
- chips 3,5,7 — free, but with NO contiguous pair: a 2-chip gang
  arrival strands on fragmentation until the defrag executor moves the
  edge-most movable blocker (the chip-6 serving replica — the planner's
  corner bias makes that choice stable) and frees the (6,7) box.
"""

from __future__ import annotations

import dataclasses
import math
import random

# Chaos event kinds, in scenario-authoring vocabulary. "gang-arrive"
# submits the 2-chip gang claim that strands on fragmentation;
# "chip-unplug"/"chip-restore" remove/return one chip (the harness
# fails over any serving replica on it); "flap-start"/"flap-stop"
# toggle FakeChipLib's deterministic presence flapping on a free chip;
# "blackout-start"/"blackout-end" bound the apiserver outage window
# (every kube.* verb raises ApiError 503 inside it).
EVENT_KINDS = (
    "gang-arrive",
    "chip-unplug",
    "chip-restore",
    "flap-start",
    "flap-stop",
    "blackout-start",
    "blackout-end",
)


@dataclasses.dataclass(frozen=True)
class TrafficClass:
    """One tenant class's diurnal arrival curve and request shape.

    ``name`` is the admission latency class (realtime / interactive /
    batch). Arrival rate sweeps ``base_rps`` → ``peak_rps`` → back over
    one scenario-duration "day" (trough at t=0, peak at mid-soak).
    Prompts are ``system_len`` shared-prefix tokens (one of
    ``n_systems`` fixed system prompts) plus ``tail_len`` unique tokens
    — the shape that makes prefix-affinity routing and the engines'
    prefix caches measurable."""

    name: str
    base_rps: float
    peak_rps: float
    n_systems: int
    system_len: int
    tail_len: int
    max_new_tokens: int
    max_queue_delay_s: float


@dataclasses.dataclass(frozen=True)
class FlashCrowd:
    """A burst of extra arrivals pinned to ONE shared system prompt —
    the thundering-herd shape prefix-affinity routing exists for."""

    start_frac: float
    end_frac: float
    rps: float
    system: int = 0
    latency_class: str = "interactive"


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One timeline entry; ``at_frac`` is a fraction of the duration,
    ``chip`` the FakeChipLib chip index where the kind needs one."""

    at_frac: float
    kind: str
    chip: int = -1


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """The soak's whole input. See the module docstring; fields group
    as clock / traffic / chaos / layout / policy knobs / gate budgets."""

    name: str
    seed: int
    duration_s: float
    tick_s: float
    driver_tick_every_s: float

    # Cluster shape + chip roles (see module docstring for the default
    # layout's reasoning).
    generation: str
    topology: str
    train_chips: tuple
    shared_chip: int
    serving_chips: tuple

    classes: tuple
    flash: FlashCrowd
    chaos: tuple

    # Gateway / admission / autoscaler / engine knobs (virtual units).
    min_replicas: int
    max_replicas: int
    queue_high_water: float
    queue_low_water: float
    dwell_ticks: int
    cooldown_s: float
    shed_watermark: int
    hard_watermark: int
    batch_slots: int
    prefill_chunk: int
    block_size: int
    rebalance_interval_s: float
    retry_cap: int

    # Gate budgets: per-class p99 ceilings (virtual seconds) and the
    # autoscaler-efficiency floor (oracle chip-seconds / actual).
    p99_budgets: tuple  # of (class, ttft_p99_s, e2e_p99_s)
    efficiency_floor: float

    vocab: int = 997

    # kv-hit-rate gate floor: the fleet's MEASURED prefix hit rate
    # (summed engine counters via the gateway's ResidencyIndex, not the
    # router's predicted affinity rate) must end the soak at or above
    # this. The default is deliberately modest — chaos drains/failovers
    # dump warm caches mid-soak — while still catching an accidentally
    # disabled or never-warming prefix cache.
    min_fleet_hit_rate: float = 0.5

    # -- derived views -----------------------------------------------------

    def rate(self, cls: TrafficClass, t: float) -> float:
        """Diurnal arrivals/s at virtual time ``t``: sinusoidal trough
        at t=0 and t=duration, peak at mid-soak."""
        day = 0.5 * (1.0 - math.cos(2.0 * math.pi * t / self.duration_s))
        return cls.base_rps + (cls.peak_rps - cls.base_rps) * day

    def flash_rate(self, t: float) -> float:
        f = self.flash
        lo, hi = f.start_frac * self.duration_s, f.end_frac * self.duration_s
        return f.rps if lo <= t < hi else 0.0

    def events_abs(self) -> list:
        """Chaos timeline as sorted (at_s, ChaosEvent) pairs."""
        out = [(e.at_frac * self.duration_s, e) for e in self.chaos]
        out.sort(key=lambda p: p[0])
        return out

    def total_rate(self, t: float) -> float:
        return sum(self.rate(c, t) for c in self.classes) + self.flash_rate(t)

    def class_named(self, name: str) -> TrafficClass:
        for c in self.classes:
            if c.name == name:
                return c
        raise KeyError(name)

    def service_ticks(self, cls: TrafficClass) -> int:
        """Cache-cold engine ticks one request of this class occupies a
        batch slot for (the oracle schedule's service-time input)."""
        prompt_len = cls.system_len + cls.tail_len
        prefill = max(1, -(-prompt_len // self.prefill_chunk))
        return prefill + cls.max_new_tokens

    def oracle_replicas(self, t: float) -> int:
        """The oracle schedule: replicas a clairvoyant autoscaler runs
        at ``t``, from the KNOWN arrival curve and the engines' known
        service rate — no queue observation, no dwell, no cooldown."""
        demand = 0.0
        flash_cls = self.class_named(self.flash.latency_class)
        for cls in self.classes:
            lam = self.rate(cls, t)
            if cls is flash_cls:
                lam += self.flash_rate(t)
            per_replica = self.batch_slots / (
                self.service_ticks(cls) * self.tick_s
            )
            demand += lam / per_replica
        return max(self.min_replicas,
                   min(self.max_replicas, math.ceil(demand)))


def poisson_draw(rng: random.Random, lam: float) -> int:
    """Knuth's product-of-uniforms Poisson sampler — deterministic for
    a seeded ``rng``, and exact for the small per-tick rates the soak
    uses (lam = rps * tick_s, well under 5)."""
    if lam <= 0.0:
        return 0
    threshold = math.exp(-lam)
    k = 0
    p = 1.0
    while True:
        p *= rng.random()
        if p <= threshold:
            return k
        k += 1


def build_class_prompts(spec: ScenarioSpec) -> dict:
    """class name -> list of fixed system-prompt token lists, from a
    seeded stream independent of the arrival draws (so tweaking rates
    never reshuffles the prompt universe)."""
    rng = random.Random(spec.seed * 7919 + 17)
    out = {}
    for cls in spec.classes:
        out[cls.name] = [
            [rng.randrange(spec.vocab) for _ in range(cls.system_len)]
            for _ in range(cls.n_systems)
        ]
    return out


def _standard(name: str, seed: int, duration_s: float) -> ScenarioSpec:
    """The five-axis acceptance scenario at a given duration. The chaos
    fractions leave each window in a phase that keeps it diagnosable:
    the gang arrives pre-peak (quiet allocator → the plan can't go
    stale before the next driver tick executes it), the flap runs on a
    free chip before the flash, failures land post-peak mid-traffic,
    and the blackout sits in the wind-down where no chip transitions
    need publishing."""
    return ScenarioSpec(
        name=name,
        seed=seed,
        duration_s=duration_s,
        tick_s=0.25,
        driver_tick_every_s=5.0,
        generation="v5p",
        topology="8x1x1",
        train_chips=(0, 1),
        shared_chip=2,
        serving_chips=(4, 6),
        classes=(
            TrafficClass(
                name="realtime", base_rps=0.10, peak_rps=0.40,
                n_systems=2, system_len=32, tail_len=4,
                max_new_tokens=6, max_queue_delay_s=30.0,
            ),
            TrafficClass(
                name="interactive", base_rps=0.30, peak_rps=1.20,
                n_systems=4, system_len=32, tail_len=4,
                max_new_tokens=8, max_queue_delay_s=120.0,
            ),
            TrafficClass(
                name="batch", base_rps=0.20, peak_rps=0.60,
                n_systems=2, system_len=32, tail_len=8,
                max_new_tokens=12, max_queue_delay_s=900.0,
            ),
        ),
        flash=FlashCrowd(start_frac=0.48, end_frac=0.56, rps=2.0,
                         system=0, latency_class="interactive"),
        chaos=(
            ChaosEvent(0.25, "gang-arrive"),
            ChaosEvent(0.35, "flap-start", chip=3),
            ChaosEvent(0.42, "flap-stop", chip=3),
            ChaosEvent(0.62, "chip-unplug", chip=4),
            ChaosEvent(0.70, "chip-restore", chip=4),
            ChaosEvent(0.73, "chip-unplug", chip=1),
            ChaosEvent(0.80, "chip-restore", chip=1),
            ChaosEvent(0.86, "blackout-start"),
            ChaosEvent(0.92, "blackout-end"),
        ),
        min_replicas=2,
        max_replicas=4,
        queue_high_water=3.0,
        queue_low_water=0.25,
        dwell_ticks=8,
        cooldown_s=45.0,
        shed_watermark=64,
        hard_watermark=512,
        batch_slots=4,
        prefill_chunk=16,
        block_size=16,
        rebalance_interval_s=30.0,
        retry_cap=5,
        p99_budgets=(
            ("realtime", 15.0, 20.0),
            ("interactive", 20.0, 30.0),
            ("batch", 60.0, 90.0),
        ),
        efficiency_floor=0.5,
    )


def smoke_scenario(seed: int = 1234) -> ScenarioSpec:
    """The ``make fleetsmoke`` profile: a 600-virtual-second day,
    minutes of wall clock, all five axes gated."""
    return _standard("fleet-smoke", seed, 600.0)


def mini_scenario(seed: int = 1234) -> ScenarioSpec:
    """The fast profile for tier-1 tests and verify_metrics' real
    mini-soak: the same five-axis timeline compressed to a
    200-virtual-second day."""
    return _standard("fleet-mini", seed, 200.0)
