"""Deterministic fault injection for the serve engine (the port's copy of
``repro/testing/chaos.py``, numpy only).

A ``ChaosInjector`` drives three failure modes through the engine's REAL
code paths -- no mocking, no monkeypatching:

* **pool squeezes** -- ``PageAllocator.seize_pages`` removes a fraction of
  the free list for a few ticks (a co-tenant, fragmentation, a shrunken
  pool), forcing mid-flight ``PoolExhausted`` and therefore the
  preempt-and-recompute path;
* **NaN ticks** -- ``engine.poison_slot_cache`` writes NaN into one active
  slot's resident K (the fp32 scale table on quantized pools), so the next
  attention pass gives non-finite logits and the NaN guard must retire
  exactly that slot;
* **dropped grants** -- ``drop_grants(tick)`` makes the engine discard a
  tick's continuous-prefill chunk plan, exercising the
  progress-resumes-next-tick guarantee.

Everything is precomputed from ``np.random.default_rng(seed)`` at
construction: the same (seed, engine, workload) triple replays the same
fault trace event for event -- and the same trace as the JAX package's
injector, since both draw from the same generator in the same order.  The
injector keeps a readable ``events`` log; two runs are *deterministic* iff
their logs and outputs match exactly.

Usage::

    chaos = ChaosInjector(ChaosConfig(seed=7, ticks=64, squeezes=2))
    eng = ServeEngine(cfg, params, serve=serve_cfg, chaos=chaos)
    ...submit / run...
    assert chaos.events == replay.events  # determinism gate
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

__all__ = ["ChaosConfig", "ChaosInjector"]


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Seeded fault-trace shape.  Event ticks are drawn without replacement
    from ``range(1, ticks)`` (tick 0 is left clean so at least one admission
    happens before the first fault)."""

    seed: int = 0
    ticks: int = 64  # horizon the event schedule is drawn over
    squeezes: int = 2  # free-list squeeze events
    squeeze_frac: float = 0.5  # fraction of currently-free pages seized
    squeeze_hold: int = 4  # ticks a squeeze holds before pages restore
    nan_ticks: int = 1  # ticks that poison one active slot's cache
    drop_ticks: int = 1  # ticks whose chunk grants are discarded

    def __post_init__(self):
        if self.ticks < 2:
            raise ValueError(f"ticks must be >= 2, got {self.ticks}")
        if not (0.0 <= self.squeeze_frac <= 1.0):
            raise ValueError(
                f"squeeze_frac must be in [0, 1], got {self.squeeze_frac}"
            )
        if self.squeeze_hold < 1:
            raise ValueError(
                f"squeeze_hold must be >= 1, got {self.squeeze_hold}"
            )
        for name in ("squeezes", "nan_ticks", "drop_ticks"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0")


class ChaosInjector:
    """Replays the seeded fault schedule against a live engine.

    The engine calls ``on_tick(engine)`` at the top of every ``step()`` and
    ``drop_grants(tick)`` before launching a chunk plan.  One injector
    belongs to ONE engine run; construct a fresh one (same config) to
    replay the identical trace."""

    def __init__(self, config: ChaosConfig):
        self.config = config
        rng = np.random.default_rng(config.seed)
        horizon = np.arange(1, config.ticks)
        n_events = config.squeezes + config.nan_ticks + config.drop_ticks
        if n_events > len(horizon):
            raise ValueError(
                f"{n_events} events do not fit in {len(horizon)} ticks"
            )
        # one draw without replacement, then split: event kinds never collide
        # on a tick, so the event ordering within a tick is never ambiguous
        picks = rng.choice(horizon, size=n_events, replace=False)
        self.squeeze_ticks = set(
            int(t) for t in picks[: config.squeezes]
        )
        self.nan_ticks = set(
            int(t)
            for t in picks[config.squeezes : config.squeezes + config.nan_ticks]
        )
        self.drop_ticks = set(
            int(t) for t in picks[config.squeezes + config.nan_ticks :]
        )
        # live state
        self._held: List[Tuple[int, List[int]]] = []  # (restore_tick, pids)
        self._nan_pending = 0  # scheduled poisons waiting for a victim
        # counters + replay log
        self.injected_squeezes = 0
        self.injected_nans = 0
        self.restored_squeezes = 0
        self.events: List[str] = []

    # -- engine hooks --------------------------------------------------------

    def on_tick(self, engine) -> None:
        """Apply this tick's faults.  Called at the top of ``step()``,
        before admission, so a squeeze constrains this tick's decisions."""
        tick = engine._tick
        # 1. restore squeezes whose hold expired (before any new seizure so
        # a restore and a squeeze on the same tick compose deterministically)
        still = []
        for restore_tick, pids in self._held:
            if tick >= restore_tick and engine.allocator is not None:
                engine.allocator.restore_pages(pids)
                self.restored_squeezes += 1
                self.events.append(f"t{tick}:restore:{len(pids)}")
            else:
                still.append((restore_tick, pids))
        self._held = still
        # 2. new squeeze: seize a fraction of whatever is free RIGHT NOW
        if tick in self.squeeze_ticks and engine.allocator is not None:
            free_now = len(engine.allocator._free)
            k = max(1, int(free_now * self.config.squeeze_frac)) if free_now else 0
            pids = engine.allocator.seize_pages(k)
            if pids:
                self._held.append((tick + self.config.squeeze_hold, pids))
                self.injected_squeezes += 1
                self.events.append(f"t{tick}:squeeze:{len(pids)}")
        # 3. NaN poison: deferred until a victim is actually decoding, so a
        # scheduled tick that lands mid-prefill still injects (next tick)
        if tick in self.nan_ticks:
            self._nan_pending += 1
        if self._nan_pending:
            victim = self._pick_nan_victim(engine)
            if victim is not None:
                engine.poison_slot_cache(victim)
                self._nan_pending -= 1
                self.injected_nans += 1
                self.events.append(f"t{tick}:nan:slot{victim}")

    def drop_grants(self, tick: int) -> bool:
        """True when this tick's chunk plan must be discarded (the engine
        counts the dropped grants)."""
        if tick in self.drop_ticks:
            self.events.append(f"t{tick}:drop_grants")
            return True
        return False

    # -- internals -----------------------------------------------------------

    @staticmethod
    def _pick_nan_victim(engine):
        """Smallest active slot that finished ingest and generated at least
        one token: it is mid-decode, so the poison provably hits a launch
        whose other rows must commit bitwise-unchanged."""
        for slot, req in enumerate(engine.scheduler.slots):
            if (
                req is not None
                and req.prefill_pos >= req.ingest_len
                and req.generated
            ):
                return slot
        return None

    def summary(self) -> dict:
        return {
            "seed": self.config.seed,
            "injected_squeezes": self.injected_squeezes,
            "restored_squeezes": self.restored_squeezes,
            "injected_nans": self.injected_nans,
            "events": list(self.events),
        }
