"""Fleet telemetry harness: the unified tick (core/tick.py) across N
simulated hosts (torch port of ``repro/obs/fleet.py``).

A fleet is a list of per-host states advanced by one tick function, host
after host within each tick. Hosts never interact, so this is exactly the
reference's ``vmap`` over a stacked state; the states are stacked to
``[H, ...]`` (``core.state.stack_hosts``) only for results. The tick calls
ctypes-bound kernels, which ``torch.func.vmap`` cannot trace, and the
reference's ``pmap`` over devices has no counterpart on one card. Three
execution surfaces:

  ``run_fleet``        — the static-layout fleet (hosts share one owner
                         vector, so they share the static provider's
                         rowspace; heterogeneity from workload data).
  ``run_mixed_fleet``  — static and churned hosts side by side on the
                         dynamic-ownership tick, full per-tick telemetry
                         and offline pathology detection.
  ``fleet_rollout``    — the long-horizon engine: chunks of ticks with the
                         per-tick outputs reduced to [H] running sums,
                         schedule archetypes gathered per host (hosts
                         sharing a schedule cost one copy), tiled
                         periodically, and the int32 counters widened to
                         int64 on the host at each chunk boundary.

Host-side, telemetry is decoded per host and rolled up fleet-wide: latency
percentiles, migration rates, pathology counts from ``obs.pathology``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import TieringConfig
from repro_torch.core.churn import ChurnSchedule, make_churn_tick
from repro_torch.core.engine import make_tick, resolve_impl, stack_outputs
from repro_torch.core.simulator import tenant_activity
from repro_torch.core.state import host_slice, init_state, stack_hosts
from repro_torch.core.workloads import (ChurnSlot, TenantWorkload,
                                        as_churn_slots, build_churn_schedule,
                                        build_trace, cache_like, ci_like,
                                        microbenchmark, spark_like, thrasher,
                                        web_like)
from repro_torch.device import resolve_device, to_host
from repro_torch.obs.attribution import (COMPONENTS, AttributionSpec,
                                         attribution_conserved,
                                         fast_hit_fraction, make_attribution)
from repro_torch.obs.pathology import Pathology, count_by_kind, detect_all
from repro_torch.obs.sketch import sketch_merge, sketch_percentiles
from repro_torch.obs.stats import stats_summary
from repro_torch.obs.streaming import (DetectorSpec, make_detector,
                                       streaming_pathologies)
from repro_torch.obs.trace import decode_ring

# stable-pattern menu for clean hosts (hot sets that mostly fit fast tier)
MIX_MENU = ("web", "cache", "micro", "ci", "spark")


def heterogeneous_mixes(footprints: Sequence[int], n_hosts: int,
                        seed: int = 0, menu: Sequence[str] = MIX_MENU,
                        stagger: int = 8) -> List[List[TenantWorkload]]:
    """One tenant mix per host. Footprints are fixed per tenant *slot* (every
    host shares the static page-ownership layout ``run_fleet`` needs); the
    workload pattern and arrival of each slot vary per host."""
    rng = np.random.default_rng(seed)
    mk = {
        "web": lambda f, a: web_like(f, arrival=a),
        "cache": lambda f, a: cache_like(f, arrival=a),
        "micro": lambda f, a: microbenchmark(f, arrival=a),
        "ci": lambda f, a: ci_like(f, arrival=a),
        "spark": lambda f, a: spark_like(f, arrival=a),
    }
    mixes = []
    for _ in range(n_hosts):
        mix = []
        for f in footprints:
            kind = menu[int(rng.integers(len(menu)))]
            arrival = int(rng.integers(0, stagger + 1))
            mix.append(mk[kind](f, arrival))
        mixes.append(mix)
    return mixes


def inject_noisy_neighbor(mixes: List[List[TenantWorkload]], tenant: int,
                          fast_share: int,
                          hosts: Optional[Sequence[int]] = None,
                          arrival: Optional[int] = None
                          ) -> List[List[TenantWorkload]]:
    """Replace ``tenant``'s workload with a thrasher (the §V-B5 noisy
    neighbor) on the given hosts (default: all). The footprint is kept so
    the fleet keeps a common ownership layout; a late ``arrival`` gives the
    detectors a clean baseline window first."""
    hosts = set(range(len(mixes))) if hosts is None else set(hosts)
    out = []
    for h, mix in enumerate(mixes):
        mix = list(mix)
        if h in hosts:
            a = mix[tenant].arrival if arrival is None else arrival
            mix[tenant] = thrasher(mix[tenant].footprint, fast_share,
                                   arrival=a)
        out.append(mix)
    return out


@dataclass
class FleetResult:
    mode: str
    n_hosts: int
    # [H, ticks, T] each
    fast_usage: np.ndarray
    slow_usage: np.ndarray
    promotions: np.ndarray
    demotions: np.ndarray
    throughput: np.ndarray
    latency: np.ndarray
    thrash_events: np.ndarray
    attempted: np.ndarray
    lower_protection: tuple
    # per-host decoded telemetry
    stats: List[dict] = field(default_factory=list)   # stats_summary per host
    pathologies: List[List[Pathology]] = field(default_factory=list)
    # [H, ticks, T] bool per-host tenant roster (tenant has live pages)
    active: Optional[np.ndarray] = None
    _final_state: object = None      # host-stacked TierState [H, ...]

    def steady_window(self, frac: float = 0.5) -> slice:
        n = self.latency.shape[1]
        return slice(int(n * (1 - frac)), n)

    def host_migrations(self, host: int):
        """Decode one host's migration ring -> (events, n_dropped)."""
        return decode_ring(host_slice(self._final_state.ring, host))

    def pathology_counts(self) -> Dict[str, int]:
        """Fleet-wide counts by kind, keys sorted."""
        out: Dict[str, int] = {}
        for ps in self.pathologies:
            for k, v in count_by_kind(ps).items():
                out[k] = out.get(k, 0) + v
        return dict(sorted(out.items()))

    def tenants_flagged(self, kind: Optional[str] = None
                        ) -> List[Tuple[int, int]]:
        """Sorted unique (host, tenant) pairs flagged, optionally for one
        pathology kind."""
        out = set()
        for h, ps in enumerate(self.pathologies):
            for p in ps:
                if kind is None or p.kind == kind:
                    out.add((h, p.tenant))
        return sorted(out)

    def rollup(self) -> dict:
        """Fleet-wide operator summary over resident tenant-ticks
        (``active``)."""
        w = self.steady_window()
        lat = self.latency[:, w]
        mig = self.promotions[:, w] + self.demotions[:, w]
        hosts_bad = sum(1 for ps in self.pathologies if ps)
        if self.active is not None:
            act = np.asarray(self.active[:, w], bool)
            act = act if act.any() else np.ones_like(act)
            lat_vals = lat[act]
            thru_vals = self.throughput[:, w][act]
            worst_host = max(
                float(np.percentile(lat[h][act[h]], 99))
                for h in range(self.n_hosts) if act[h].any())
        else:
            lat_vals, thru_vals = lat, self.throughput[:, w]
            worst_host = float(np.percentile(lat, 99, axis=(1, 2)).max())
        return {
            "hosts": self.n_hosts,
            "ticks": self.latency.shape[1],
            "tenants": self.latency.shape[2],
            "latency_p50": float(np.percentile(lat_vals, 50)),
            "latency_p99": float(np.percentile(lat_vals, 99)),
            "latency_worst_host_p99": worst_host,
            "throughput_mean": float(thru_vals.mean()),
            "migrations_per_tick": float(mig.sum(axis=2).mean()),
            "thrash_total": int(self.thrash_events[:, -1].sum()),
            "pathology_counts": self.pathology_counts(),
            "hosts_with_pathology": hosts_bad,
        }


def _fleet_result(mode: str, cfg: TieringConfig, finals, outs,
                  active: np.ndarray, detect: bool) -> FleetResult:
    """One FleetResult builder shared by the static and mixed fleets.
    ``outs``: one stacked TickOutput ([ticks, ...]) per host."""
    H = active.shape[0]

    def field_(f):
        return np.stack([to_host(getattr(o, f)) for o in outs])

    res = FleetResult(
        mode=mode, n_hosts=H,
        fast_usage=field_("fast_usage"), slow_usage=field_("slow_usage"),
        promotions=field_("promotions"), demotions=field_("demotions"),
        throughput=field_("throughput"), latency=field_("latency"),
        thrash_events=field_("thrash_events"),
        attempted=field_("attempted_promotions"),
        lower_protection=tuple(cfg.lower_protection[:cfg.n_tenants]),
        active=active,
        _final_state=finals)
    res.stats = [stats_summary(host_slice(finals.stats, h))
                 for h in range(H)]
    if detect:
        res.pathologies = [
            detect_all(res.fast_usage[h], res.slow_usage[h],
                       res.promotions[h], res.demotions[h], res.latency[h],
                       res.thrash_events[h], attempted=res.attempted[h],
                       lower_protection=res.lower_protection,
                       active=res.active[h])
            for h in range(H)]
    return res


def _advance(tick, states: list, inputs) -> list:
    """One fleet tick: every host in turn through the same tick function.
    ``inputs(h)`` gives host h's tick inputs. Returns the hosts' outputs."""
    outs = []
    for h, st in enumerate(states):
        states[h], out = tick(st, inputs(h))
        outs.append(out)
    return outs


def run_fleet(cfg: TieringConfig, host_mixes: List[List[TenantWorkload]],
              ticks: int, mode: str = "equilibria", k_max: int = 64,
              detect: bool = True, impl: Optional[str] = None,
              device="cuda") -> FleetResult:
    """Run every host's trace through one static-provider tick.

    All hosts must share the tenant footprint layout (same owner vector);
    ``heterogeneous_mixes`` guarantees that by construction. For fleets
    mixing static and churned hosts, use ``run_mixed_fleet``. ``impl``:
    "cuda" on a card, "ref" on the CPU by default ("batched" the plain
    mirror of the reference's default path).
    """
    dev = resolve_device(device)
    traces = [build_trace(mix, ticks) for mix in host_mixes]
    owner = traces[0][0]
    for o, _, _ in traces[1:]:
        if not np.array_equal(o, owner):
            raise ValueError("all hosts must share the footprint layout "
                             "(same per-tenant page counts)")
    cfg = cfg.with_(n_tenants=len(host_mixes[0]))
    H = len(host_mixes)
    accesses = torch.as_tensor(
        np.stack([t[1] for t in traces]).astype(np.float32), device=dev)
    alive = torch.as_tensor(np.stack([t[2] for t in traces]).astype(bool),
                            device=dev)

    tick = make_tick(cfg, owner, mode, k_max, impl=resolve_impl(impl, dev),
                     device=dev)
    states = [init_state(cfg, owner.shape[0], owner=owner, device=dev)
              for _ in range(H)]
    per_host: List[list] = [[] for _ in range(H)]
    for t in range(ticks):
        outs = _advance(tick, states, lambda h: (accesses[h, t], alive[h, t]))
        for h, o in enumerate(outs):
            per_host[h].append(o)
    active = np.stack([tenant_activity(owner, np.asarray(tr[2]),
                                       cfg.n_tenants) for tr in traces])
    return _fleet_result(mode, cfg, stack_hosts(states),
                         [stack_outputs(o) for o in per_host], active, detect)


# --------------------------------------------------------- mixed fleets ----
def stack_schedules(schedules: List[ChurnSchedule]
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Stack per-host churn schedules into fleet arrays, padding every
    host's rates to the fleet-wide max slot footprint: (want [H, ticks, T]
    int32, rates [H, ticks, T, S] f32). Hosts must share slot count and
    horizon."""
    ticks, T = schedules[0].want.shape
    for s in schedules[1:]:
        if s.want.shape != (ticks, T):
            raise ValueError("all hosts must share slot count and horizon; "
                             f"got {s.want.shape} vs {(ticks, T)}")
    S = max(s.rates.shape[2] for s in schedules)
    H = len(schedules)
    want = np.stack([s.want for s in schedules]).astype(np.int32)
    rates = np.zeros((H, ticks, T, S), np.float32)
    for h, s in enumerate(schedules):
        rates[h, :, :, :s.rates.shape[2]] = s.rates
    return want, rates


def mixed_fleet_hosts(static_mixes: List[List[TenantWorkload]],
                      churn_hosts: List[List[ChurnSlot]],
                      ticks: int) -> List[List[ChurnSlot]]:
    """Normalize a heterogeneous fleet to churn-slot rosters: static hosts
    become single-episode slots (the degenerate schedule)."""
    return [as_churn_slots(mix, ticks) for mix in static_mixes] + \
        [list(slots) for slots in churn_hosts]


def run_mixed_fleet(cfg: TieringConfig, hosts: List[List[ChurnSlot]],
                    ticks: int, mode: str = "equilibria", k_max: int = 64,
                    detect: bool = True, n_pages: Optional[int] = None,
                    impl: Optional[str] = None, device="cuda"
                    ) -> FleetResult:
    """Heterogeneous fleet: static and churned hosts side by side on the
    dynamic-ownership tick. ``hosts`` is one churn-slot roster per host
    (``mixed_fleet_hosts`` builds it); every host needs the same slot
    count. ``impl`` as for ``run_fleet``."""
    dev = resolve_device(device)
    T = len(hosts[0])
    for slots in hosts[1:]:
        if len(slots) != T:
            raise ValueError("all hosts must have the same slot count")
    cfg = cfg.with_(n_tenants=T)
    want, rates = stack_schedules(
        [build_churn_schedule(slots, ticks) for slots in hosts])
    H = want.shape[0]
    L = n_pages if n_pages is not None else \
        cfg.n_fast_pages + cfg.n_slow_pages
    tick = make_churn_tick(cfg, L, mode=mode, k_max=k_max,
                           impl=resolve_impl(impl, dev), device=dev)
    states = [init_state(cfg, L, device=dev) for _ in range(H)]
    want_d = torch.as_tensor(want, device=dev)
    rates_d = torch.as_tensor(rates, device=dev)
    per_host: List[list] = [[] for _ in range(H)]
    for t in range(ticks):
        outs = _advance(tick, states, lambda h: (rates_d[h, t], want_d[h, t]))
        for h, o in enumerate(outs):
            per_host[h].append(o)
    return _fleet_result(mode, cfg, stack_hosts(states),
                         [stack_outputs(o) for o in per_host], want > 0,
                         detect)


# ----------------------------------------------- long-horizon rollouts ----
_WRAP32 = 1 << 32


def _np_tree_map(fn, tree, *rest):
    """``fn`` over the array leaves of a tree of dicts and NamedTuples."""
    if isinstance(tree, dict):
        return {k: _np_tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_np_tree_map(fn, getattr(tree, f),
                                         *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    return fn(tree, *rest)


class CounterLedger:
    """Wrap-safe host-side int64 widening of the tick's int32 counters.

    The cumulative counters (``Counters``, the attribution ledger) are int32
    on the device and wrap at fleet horizons. The ledger widens at the chunk
    boundary: counters are monotone mod 2^32, so ``(now - prev) mod 2^32``
    is the exact growth of a chunk that grows a counter by < 2^32 (a chunk
    of C ticks grows a per-tenant counter by at most C * L). The int64
    totals stay exact at any horizon while the device state stays int32.
    """

    def __init__(self, tree):
        self.prev = _np_tree_map(lambda x: to_host(x).astype(np.int64), tree)
        self.total = _np_tree_map(np.zeros_like, self.prev)

    def absorb(self, tree) -> None:
        now = _np_tree_map(lambda x: to_host(x).astype(np.int64), tree)
        self.total = _np_tree_map(lambda t, p, n: t + ((n - p) % _WRAP32),
                                  self.total, self.prev, now)
        self.prev = now


def make_fleet_chunk(tick, want_d: torch.Tensor, rates_d: torch.Tensor,
                     period: int, n: int):
    """The chunk program: ``n`` fleet ticks, each host's schedule column
    gathered from its archetype (tick t reads column ``t % period``), the
    per-tick outputs reduced to per-host running sums in the reference's
    order: ``latency.mean(-1)`` and ``throughput.sum(-1)`` in float32, the
    migrations in int32 (exact up to 2^31 a chunk; widened on the host).

    Returns ``chunk_fn(states, arch, t0) -> (states, (lat [H], thr [H], mig
    [H]))`` over a list of per-host states and their archetype ids."""
    def chunk_fn(states: list, arch: Sequence[int], t0: int):
        dev = want_d.device
        lat = [torch.zeros((), dtype=torch.float32, device=dev)
               for _ in arch]
        thr = [torch.zeros((), dtype=torch.float32, device=dev)
               for _ in arch]
        mig = [torch.zeros((), dtype=torch.int32, device=dev) for _ in arch]
        for i in range(n):
            tm = (t0 + i) % period
            outs = _advance(tick, states,
                            lambda h: (rates_d[arch[h], tm],
                                       want_d[arch[h], tm]))
            for h, out in enumerate(outs):
                lat[h] = lat[h] + out.latency.mean(dim=-1)
                thr[h] = thr[h] + out.throughput.sum(dim=-1)
                mig[h] = mig[h] + (out.promotions + out.demotions).sum(
                    dim=-1, dtype=torch.int32)
        return states, (torch.stack(lat), torch.stack(thr), torch.stack(mig))
    return chunk_fn


@dataclass
class RolloutSummary:
    """Chunked-rollout result: final fleet state plus streamed per-host
    reductions (per-tick arrays are never kept: output memory is O(1) in
    the horizon)."""
    n_hosts: int
    ticks: int
    chunk: int
    sharded: bool
    elapsed_s: float                 # wall time of the rollout loop
    latency_mean: np.ndarray         # [H] mean per-tick tenant-mean latency
    throughput_mean: np.ndarray      # [H] mean per-tick total throughput
    migrations_per_tick: np.ndarray  # [H]
    final_state: object = None       # host-stacked TierState [H, ...]
    detector: Optional[DetectorSpec] = None
    attribution: Optional[AttributionSpec] = None
    # host-side int64 widening of the int32 cumulative counters
    # ({"counters": Counters, "att": {...}}), exact at any horizon
    ledger: Optional[CounterLedger] = None

    @property
    def host_ticks_per_s(self) -> float:
        return self.n_hosts * self.ticks / max(self.elapsed_s, 1e-9)

    def host_stats(self, host: int) -> dict:
        return stats_summary(host_slice(self.final_state.stats, host))

    def counters(self):
        """Cumulative per-tenant counters [H, T]: with the chunk-boundary
        ledger, int64 and exact even where the int32 state wrapped."""
        if self.ledger is not None:
            return self.ledger.total["counters"]
        return _np_tree_map(_host, self.final_state.counters)

    def host_migrations(self, host: int):
        """Decode one host's migration ring -> (events, n_dropped)."""
        return decode_ring(host_slice(self.final_state.ring, host))

    # ---- streaming pathology telemetry (obs/streaming.py) ----------------
    def host_pathologies(self, host: int) -> List[Pathology]:
        """One host's end-of-run pathologies from its streamed counters."""
        if self.detector is None:
            raise ValueError("rollout ran with detect=False")
        return streaming_pathologies(
            self.detector, host_slice(self.final_state.det, host))

    def pathology_flag_ticks(self) -> np.ndarray:
        """[H, T, len(KINDS)] int32: ticks each running flag held."""
        return to_host(self.final_state.det.flag_ticks)

    def pathology_first_flag(self) -> np.ndarray:
        """[H, T, len(KINDS)] int32: first tick each flag held (-1 never)."""
        return to_host(self.final_state.det.first_flag)

    def pathology_counts(self) -> Dict[str, int]:
        """Fleet-wide end-of-run counts by kind, keys sorted."""
        out: Dict[str, int] = {}
        for h in range(self.n_hosts):
            for k, v in count_by_kind(self.host_pathologies(h)).items():
                out[k] = out.get(k, 0) + v
        return dict(sorted(out.items()))

    def tenants_flagged(self, kind: Optional[str] = None
                        ) -> List[Tuple[int, int]]:
        """Sorted unique (host, tenant) pairs flagged end-of-run."""
        out = set()
        for h in range(self.n_hosts):
            for p in self.host_pathologies(h):
                if kind is None or p.kind == kind:
                    out.add((h, p.tenant))
        return sorted(out)

    # ---- slowdown attribution ledger (obs/attribution.py) ----------------
    def _att(self):
        if self.attribution is None:
            raise ValueError("rollout ran with attrib=False")
        return self.final_state.attrib

    def _att_ledger(self) -> Optional[dict]:
        if self.ledger is not None and "att" in self.ledger.total:
            if self.attribution is None:
                raise ValueError("rollout ran with attrib=False")
            return self.ledger.total["att"]
        return None

    def attribution_components(self) -> np.ndarray:
        """[H, T, len(COMPONENTS)] int64 cumulative stall units by cause
        (ledger-widened: exact past int32 wrap)."""
        led = self._att_ledger()
        if led is not None:
            return led["comp"]
        return to_host(self._att().comp).astype(np.int64)

    def attribution_totals(self) -> np.ndarray:
        """[H, T] int64 cumulative stall units (== components summed)."""
        led = self._att_ledger()
        if led is not None:
            return led["total"]
        return to_host(self._att().total).astype(np.int64)

    def fast_hit_fraction(self) -> np.ndarray:
        """[H, T] fraction of access mass served from the fast tier."""
        return fast_hit_fraction(self._att())

    def stall_sketch(self) -> np.ndarray:
        """Fleet-merged per-tick stall-unit histogram ([SKETCH_BUCKETS])."""
        led = self._att_ledger()
        if led is not None:
            return sketch_merge(led["sketch"])
        return sketch_merge(self._att().sketch)

    def stall_percentiles(self, qs=(0.5, 0.95, 0.99)) -> np.ndarray:
        """Fleet-wide per-tick total-stall percentiles from the merged
        sketch."""
        return np.asarray(sketch_percentiles(self.stall_sketch(), qs))

    def attribution_conserved(self) -> bool:
        """Every host's ledger conserves: components sum to the total and
        the total matches the counter identity, exactly (on the widened
        values, so past the int32 wrap too)."""
        led = self._att_ledger()
        if led is not None:
            c = self.counters()
            comp, total = led["comp"], led["total"]
            expect = (np.asarray(c.attempted_promotions, np.int64)
                      - np.asarray(c.promotions, np.int64)
                      + np.asarray(c.reclaims, np.int64))
            return bool((comp.sum(axis=-1) == total).all()
                        and (comp >= 0).all()
                        and (total == expect).all())
        return attribution_conserved(self._att(), self.final_state.counters)

    def attribution_rollup(self) -> dict:
        """Operator roll-up: fleet component shares, worst tenant, sketch
        percentiles."""
        comp = self.attribution_components()
        total = self.attribution_totals()
        fleet = comp.sum(axis=(0, 1))
        denom = max(int(fleet.sum()), 1)
        worst = np.unravel_index(np.argmax(total), total.shape)
        p50, p95, p99 = self.stall_percentiles((0.5, 0.95, 0.99))
        return {
            "hosts": self.n_hosts,
            "ticks": self.ticks,
            "stall_units_total": int(total.sum()),
            "component_totals": {k: int(v)
                                 for k, v in zip(COMPONENTS, fleet)},
            "component_shares": {k: float(v) / denom
                                 for k, v in zip(COMPONENTS, fleet)},
            "worst_tenant": (int(worst[0]), int(worst[1])),
            "worst_tenant_stall": int(total[worst]),
            "stall_p50": float(p50),
            "stall_p95": float(p95),
            "stall_p99": float(p99),
            "conserved": self.attribution_conserved(),
        }

    def pathology_rollup(self) -> dict:
        """Operator roll-up of the streamed pathology state."""
        flagged = self.tenants_flagged()
        first = self.pathology_first_flag()
        return {
            "hosts": self.n_hosts,
            "ticks": self.ticks,
            "pathology_counts": self.pathology_counts(),
            "tenants_flagged": flagged,
            "hosts_with_pathology": len({h for h, _ in flagged}),
            "earliest_flag_tick": (int(first[first >= 0].min())
                                   if (first >= 0).any() else -1),
        }


def fleet_rollout(cfg: TieringConfig, want: np.ndarray, rates: np.ndarray,
                  ticks: int, *, host_arch: Optional[np.ndarray] = None,
                  mode: str = "equilibria", k_max: int = 64,
                  chunk: int = 256, n_pages: Optional[int] = None,
                  shard: bool = True, warmup: bool = False,
                  detect: bool = True, attrib: bool = True,
                  impl: Optional[str] = None, device="cuda"
                  ) -> RolloutSummary:
    """Advance a fleet over a long horizon in chunks.

    want [A, P, T] / rates [A, P, T, S] are schedule *archetypes* over a
    period P; ``host_arch`` [H] maps each host to its archetype (default:
    one host per archetype). Tick t reads column ``t % P`` of its host's
    archetype, so H hosts over a long horizon cost O(A * P) schedule memory.

    Each chunk advances every host ``chunk`` ticks (``make_fleet_chunk``);
    at each chunk boundary the int32 counters are widened into the
    ``CounterLedger``. ``shard`` is accepted for the reference's signature
    and has no effect: one card holds the fleet (``sharded`` is False).
    ``warmup=True`` first runs one throwaway chunk (and the remainder
    chunk) on scratch states, which builds the kernels, so ``elapsed_s``
    measures steady-state execution; the clock stops after the device
    finished. ``detect=True`` carries the streaming pathology detectors,
    ``attrib=True`` the slowdown-attribution ledger (both O(H * T) state).
    ``impl`` as for ``run_fleet``.
    """
    dev = resolve_device(device)
    want = np.asarray(want)
    rates = np.asarray(rates)
    A, period, T = want.shape
    host_arch = np.arange(A) if host_arch is None else np.asarray(host_arch)
    if host_arch.size and (host_arch.min() < 0 or host_arch.max() >= A):
        raise ValueError(f"host_arch must map into [0, {A}) archetypes")
    H = host_arch.shape[0]
    arch = [int(a) for a in host_arch]
    L = n_pages if n_pages is not None else \
        cfg.n_fast_pages + cfg.n_slow_pages
    cfg = cfg.with_(n_tenants=T)
    det_spec = (make_detector(ticks, T, cfg.lower_protection)
                if detect else None)
    att_spec = make_attribution(T, cfg.lat_fast) if attrib else None
    tick = make_churn_tick(cfg, L, mode=mode, k_max=k_max, detector=det_spec,
                           attrib=att_spec, impl=resolve_impl(impl, dev),
                           device=dev)
    want_d = torch.as_tensor(want.astype(np.int32), device=dev)
    rates_d = torch.as_tensor(rates.astype(np.float32), device=dev)

    chunk = max(min(chunk, ticks), 1)
    n_full, rem = divmod(ticks, chunk)
    run_chunk = make_fleet_chunk(tick, want_d, rates_d, period, chunk)
    run_rem = (make_fleet_chunk(tick, want_d, rates_d, period, rem)
               if rem else None)

    def fresh():
        return [init_state(cfg, L, device=dev, detector=det_spec,
                           attrib=att_spec) for _ in range(H)]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if warmup:
        scratch, _ = run_chunk(fresh(), arch, 0)
        if run_rem is not None:
            run_rem(scratch, arch, 0)
        sync()

    states = fresh()
    lat_sum = np.zeros(H, np.float64)
    thr_sum = np.zeros(H, np.float64)
    mig_sum = np.zeros(H, np.int64)

    def ledger_view(sts: list):
        tree = {"counters": stack_hosts([s.counters for s in sts])}
        if att_spec is not None:
            tree["att"] = {f: torch.stack([getattr(s.attrib, f) for s in sts])
                           for f in ("comp", "total", "sketch")}
        return tree

    ledger = CounterLedger(ledger_view(states))

    def absorb(acc):
        nonlocal lat_sum, thr_sum, mig_sum
        lat, thr, mig = (to_host(a).reshape(H) for a in acc)
        lat_sum = lat_sum + lat
        thr_sum = thr_sum + thr
        # the chunk's int32 migration count, widened wrap-safe like the
        # cumulative counters (exact while one chunk migrates < 2^32 pages)
        mig_sum = mig_sum + (mig.astype(np.int64) % _WRAP32)

    t0_wall = time.perf_counter()
    t = 0
    for _ in range(n_full):
        states, acc = run_chunk(states, arch, t)
        absorb(acc)
        ledger.absorb(ledger_view(states))
        t += chunk
    if run_rem is not None:
        states, acc = run_rem(states, arch, t)
        absorb(acc)
        ledger.absorb(ledger_view(states))
        t += rem
    sync()
    elapsed = time.perf_counter() - t0_wall

    return RolloutSummary(
        n_hosts=H, ticks=ticks, chunk=chunk, sharded=False,
        elapsed_s=elapsed,
        latency_mean=lat_sum / ticks,
        throughput_mean=thr_sum / ticks,
        migrations_per_tick=mig_sum / ticks,
        final_state=stack_hosts(states), detector=det_spec,
        attribution=att_spec, ledger=ledger)
