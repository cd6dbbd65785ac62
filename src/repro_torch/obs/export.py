"""Host-side telemetry exporters (torch port of ``repro/obs/export.py``):
the migration event ring as a Chrome-trace/Perfetto JSON timeline, and
fleet counters + histogram percentiles as Prometheus text exposition. For
the same inputs the text is identical to the reference's.

Both exporters consume decoded telemetry (``decode_ring`` events,
``Counters``/``TierStats`` arrays, streaming ``DetectorState`` counters;
tensors are copied to the host first) — they cost nothing unless an
operator asks for them. Each has a validator:

  * ``validate_chrome_trace`` — the object round-trips as JSON, every event
    carries the required fields, and timestamps are monotone per track
    (pid = host, tid = tenant).
  * ``validate_exposition`` — every line matches the Prometheus text-format
    grammar, sample names belong to a declared metric family, and histogram
    series are cumulative with a ``+Inf`` bucket equal to ``_count``.
"""
from __future__ import annotations

import json
import re
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.device import to_host
from repro_torch.obs.attribution import COMPONENTS
from repro_torch.obs.sketch import sketch_edges, sketch_percentile
from repro_torch.obs.stats import bucket_edges, hist_percentile
from repro_torch.obs.streaming import KINDS
from repro_torch.obs.trace import DIR_PROMOTE, ring_summary

TICK_US = 1000          # one engine tick rendered as 1ms of trace time
QUANTILES = (0.5, 0.95, 0.99)
# the reference's generator name: both packages emit the same trace JSON
GENERATOR = "repro.obs.export"


# ----------------------------------------------------- Chrome trace ---------
def chrome_trace(host_events: Mapping[int, np.ndarray], *,
                 t_resident: int = 8, horizon: Optional[int] = None,
                 tick_us: int = TICK_US) -> dict:
    """Render decoded migration rings as a Chrome-trace object (load the
    JSON in ui.perfetto.dev or chrome://tracing).

    ``host_events``: {host_id: structured EVENT_DTYPE array, oldest->newest
    (``decode_ring`` output)}. One trace *process* per host, one *thread*
    (track) per tenant. A promote->demote pair of the same page becomes one
    complete-event span — named ``thrash`` when the residency beat
    ``t_resident`` (cfg.t_resident: the §IV-F thrash signature), else
    ``fast_resident``. A demote with no opening promote in the ring window
    is an instant event; promotes still open at the end close at
    ``horizon`` (default: last event tick + 1) as ``fast_resident_open``.
    Events are sorted by (pid, tid, ts) so timestamps are monotone per
    track — the property ``validate_chrome_trace`` checks.
    """
    trace_events: List[dict] = []
    for host in sorted(host_events):
        ev = host_events[host]
        end = horizon if horizon is not None else \
            (int(ev["tick"].max()) + 1 if len(ev) else 0)
        trace_events.append({"ph": "M", "name": "process_name", "pid": host,
                             "tid": 0, "args": {"name": f"host{host}"}})
        for tn in sorted({int(x) for x in ev["tenant"]}):
            trace_events.append({"ph": "M", "name": "thread_name",
                                 "pid": host, "tid": tn,
                                 "args": {"name": f"tenant{tn}"}})
        open_promote: Dict[int, np.void] = {}
        spans: List[dict] = []
        for rec in ev:
            tick, tenant, page = (int(rec["tick"]), int(rec["tenant"]),
                                  int(rec["page"]))
            if int(rec["direction"]) == DIR_PROMOTE:
                open_promote[page] = rec
                continue
            opener = open_promote.pop(page, None)
            if opener is None:
                # its promote was overwritten by ring wraparound
                spans.append({"ph": "i", "s": "t", "name": "demote",
                              "cat": "migration", "pid": host, "tid": tenant,
                              "ts": tick * tick_us,
                              "args": {"page": page,
                                       "hotness": float(rec["hotness"])}})
                continue
            dur = tick - int(opener["tick"])
            spans.append({
                "ph": "X", "cat": "migration",
                "name": "thrash" if dur < t_resident else "fast_resident",
                "pid": host, "tid": tenant,
                "ts": int(opener["tick"]) * tick_us,
                "dur": max(dur * tick_us, 1),
                "args": {"page": page, "residency_ticks": dur,
                         "hotness_promote": float(opener["hotness"]),
                         "hotness_demote": float(rec["hotness"])}})
        for page, opener in open_promote.items():
            dur = max(end - int(opener["tick"]), 0)
            spans.append({
                "ph": "X", "cat": "migration", "name": "fast_resident_open",
                "pid": host, "tid": int(opener["tenant"]),
                "ts": int(opener["tick"]) * tick_us,
                "dur": max(dur * tick_us, 1),
                "args": {"page": page, "residency_ticks": dur,
                         "hotness_promote": float(opener["hotness"])}})
        spans.sort(key=lambda e: (e["tid"], e["ts"], e.get("dur", 0)))
        trace_events.extend(spans)
    return {"traceEvents": trace_events, "displayTimeUnit": "ms",
            "otherData": {"generator": GENERATOR,
                          "tick_us": tick_us}}


def write_chrome_trace(path: str, host_events: Mapping[int, np.ndarray],
                       **kwargs) -> dict:
    trace = chrome_trace(host_events, **kwargs)
    with open(path, "w") as f:
        json.dump(trace, f)
    return trace


def validate_chrome_trace(trace) -> int:
    """Raise ValueError unless ``trace`` is a well-formed Chrome-trace object
    with per-track monotone timestamps and balanced B/E duration spans.
    Accepts the object or its JSON text. Returns the number of non-metadata
    events validated."""
    if isinstance(trace, (str, bytes)):
        trace = json.loads(trace)
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError("trace must be an object with 'traceEvents'")
    events = trace["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    last_ts: Dict[Tuple[int, int], float] = {}
    open_spans: Dict[Tuple[int, int], List[str]] = {}
    n = 0
    for i, e in enumerate(events):
        if not isinstance(e, dict) or "ph" not in e:
            raise ValueError(f"event {i}: not an object with 'ph'")
        ph = e["ph"]
        if ph == "M":
            continue
        for k in ("ts", "pid", "tid", "name"):
            if k not in e:
                raise ValueError(f"event {i}: missing '{k}'")
        if ph == "X" and e.get("dur", -1) < 0:
            raise ValueError(f"event {i}: complete event needs dur >= 0")
        key = (e["pid"], e["tid"])
        if e["ts"] < last_ts.get(key, float("-inf")):
            raise ValueError(f"event {i}: ts not monotone on track {key}")
        last_ts[key] = e["ts"]
        # B/E duration events nest as a per-track stack (trace-format spec)
        if ph == "B":
            open_spans.setdefault(key, []).append(e["name"])
        elif ph == "E":
            stack = open_spans.get(key)
            if not stack:
                raise ValueError(f"event {i}: 'E' with no open 'B' on "
                                 f"track {key}")
            stack.pop()
        n += 1
    for key, stack in open_spans.items():
        if stack:
            raise ValueError(f"track {key}: unclosed 'B' span(s) "
                             f"{stack!r} at end of trace")
    return n


# ------------------------------------------------- Prometheus text ----------
_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")
# label values allow exactly three escapes: \\ \" \n (text-format spec);
# a stray backslash before anything else is a malformed sample
_LABEL_VAL = r"(?:\\[\\\"n]|[^\"\\\n])*"
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[a-zA-Z_][a-zA-Z0-9_]*=\"" + _LABEL_VAL + r"\""
    r"(?:,[a-zA-Z_][a-zA-Z0-9_]*=\"" + _LABEL_VAL + r"\")*,?)?\})?"
    r" (?P<value>[+-]?(?:[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?|Inf|NaN))"
    r"(?: [0-9]+)?$")
_TYPES = ("counter", "gauge", "histogram", "summary", "untyped")


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


def prom_lines(name: str, help_: str, type_: str,
               samples: Iterable[Tuple[Mapping[str, object], float]],
               suffixed: bool = False) -> List[str]:
    """One metric family in text exposition format. ``samples`` is an
    iterable of ({label: value}, numeric). ``suffixed=True`` lets samples
    carry their own full name (histogram _bucket/_sum/_count) in a
    ``__name__`` pseudo-label."""
    assert _NAME_RE.fullmatch(name), name
    assert type_ in _TYPES, type_
    lines = [f"# HELP {name} {help_}", f"# TYPE {name} {type_}"]
    for labels, value in samples:
        labels = dict(labels)
        sample_name = labels.pop("__name__", name) if suffixed else name
        lab = ",".join(f'{k}="{_escape(str(v))}"'
                       for k, v in labels.items())
        lab = f"{{{lab}}}" if lab else ""
        if isinstance(value, float) and value != value:
            val = "NaN"
        elif value in (float("inf"), float("-inf")):
            val = "+Inf" if value > 0 else "-Inf"
        elif float(value) == int(value):
            val = str(int(value))
        else:
            val = repr(float(value))
        lines.append(f"{sample_name}{lab} {val}")
    return lines


def fleet_exposition(counters: Mapping[str, np.ndarray],
                     resid_hist: Optional[np.ndarray] = None,
                     flag_ticks: Optional[np.ndarray] = None,
                     first_flag: Optional[np.ndarray] = None,
                     kinds: Sequence[str] = KINDS,
                     stall_components: Optional[np.ndarray] = None,
                     stall_totals: Optional[np.ndarray] = None,
                     stall_sketch: Optional[np.ndarray] = None,
                     component_names: Sequence[str] = COMPONENTS,
                     ring_events: Optional[np.ndarray] = None,
                     ring_dropped: Optional[np.ndarray] = None,
                     prefix: str = "equilibria") -> str:
    """Fleet telemetry as Prometheus text exposition.

    counters:   {metric: [H, T] int array} cumulative counts (e.g. the
                ``Counters`` fields: promotions, demotions, ...).
    resid_hist: [H, T, NB] log2 fast-residency histograms -> native
                histogram series (le = *exclusive* upper edge of each log2
                bucket, i.e. the next bucket's lower edge) plus
                p50/p95/p99 quantile gauges via ``hist_percentile``.
    flag_ticks / first_flag: [H, T, K] streaming pathology counters.
    stall_components / stall_totals: attribution-ledger stall units
                ([H, T, C] by cause and [H, T] totals) -> labelled
                counters; the conservation invariant makes the component
                series sum to the total series exactly.
    stall_sketch: merged [SKETCH_BUCKETS] per-tick stall histogram ->
                one fleet-level native histogram + quantile gauges.
    ring_events / ring_dropped: [H] migration-ring wrap accounting
                (``ring_summary``): events ever recorded vs overwritten.
    """
    lines: List[str] = []
    for metric in sorted(counters):
        arr = to_host(counters[metric])
        H, T = arr.shape
        lines += prom_lines(
            f"{prefix}_{metric}_total",
            f"Cumulative {metric} per host/tenant.", "counter",
            [({"host": h, "tenant": t}, float(arr[h, t]))
             for h in range(H) for t in range(T)])

    if resid_hist is not None:
        resid_hist = to_host(resid_hist)
        H, T, NB = resid_hist.shape
        edges = bucket_edges(NB)
        # le of bucket i = exclusive upper edge = lower edge of bucket i+1
        les = [str(int(e)) for e in edges[1:]] + ["+Inf"]
        name = f"{prefix}_fast_residency_ticks"
        samples = []
        for h in range(H):
            for t in range(T):
                cum = np.cumsum(resid_hist[h, t])
                for i, le in enumerate(les):
                    samples.append(({"__name__": f"{name}_bucket",
                                     "host": h, "tenant": t, "le": le},
                                    float(cum[min(i, NB - 1)])))
                samples.append(({"__name__": f"{name}_count",
                                 "host": h, "tenant": t}, float(cum[-1])))
                # lower-edge approximation of the sum (log2 buckets)
                samples.append(({"__name__": f"{name}_sum", "host": h,
                                 "tenant": t},
                                float((resid_hist[h, t] * edges).sum())))
        lines += prom_lines(
            name, "Fast-tier residency at demotion/free (ticks; log2 "
            "buckets, sum approximated by bucket lower edges).",
            "histogram", samples, suffixed=True)
        qname = f"{prefix}_fast_residency_ticks_quantile"
        qsamples = []
        for q in QUANTILES:
            for h in range(H):
                p = hist_percentile(resid_hist[h], q)
                qsamples += [({"host": h, "tenant": t, "quantile": q},
                              float(p[t])) for t in range(T)]
        lines += prom_lines(
            qname, "Residency percentile (bucket lower edge).", "gauge",
            qsamples)

    if stall_components is not None:
        stall_components = to_host(stall_components)
        H, T, C = stall_components.shape
        lines += prom_lines(
            f"{prefix}_stall_component_total",
            "Cumulative attributed stall units by cause (conserves: "
            "components sum to stall_units_total).", "counter",
            [({"host": h, "tenant": t, "component": component_names[c]},
              float(stall_components[h, t, c]))
             for h in range(H) for t in range(T) for c in range(C)])
    if stall_totals is not None:
        stall_totals = to_host(stall_totals)
        H, T = stall_totals.shape
        lines += prom_lines(
            f"{prefix}_stall_units_total",
            "Cumulative attributed stall units per host/tenant.", "counter",
            [({"host": h, "tenant": t}, float(stall_totals[h, t]))
             for h in range(H) for t in range(T)])
    if stall_sketch is not None:
        stall_sketch = to_host(stall_sketch)
        edges = np.asarray(sketch_edges())
        cum = np.cumsum(stall_sketch.astype(np.int64))
        name = f"{prefix}_stall_units_per_tick"
        les = [("%g" % e) for e in edges[1:]] + ["+Inf"]
        samples = [({"__name__": f"{name}_bucket", "le": le},
                    float(cum[min(i, len(cum) - 1)]))
                   for i, le in enumerate(les)]
        samples.append(({"__name__": f"{name}_count"}, float(cum[-1])))
        samples.append(({"__name__": f"{name}_sum"},
                        float((stall_sketch * edges[:-1]).sum())))
        lines += prom_lines(
            name, "Fleet per-tenant-tick total stall units (mergeable "
            "sketch; sum approximated by bucket lower edges).",
            "histogram", samples, suffixed=True)
        lines += prom_lines(
            f"{prefix}_stall_units_quantile",
            "Stall-units percentile across tenant-ticks (sketch bucket "
            "lower edge).", "gauge",
            [({"quantile": q}, float(sketch_percentile(stall_sketch, q)))
             for q in QUANTILES])
    if ring_events is not None:
        ring_events = to_host(ring_events).reshape(-1)
        lines += prom_lines(
            f"{prefix}_ring_events_total",
            "Migration events ever recorded into the host's ring.",
            "counter",
            [({"host": h}, float(v)) for h, v in enumerate(ring_events)])
    if ring_dropped is not None:
        ring_dropped = to_host(ring_dropped).reshape(-1)
        lines += prom_lines(
            f"{prefix}_ring_dropped_total",
            "Migration events lost to ring wraparound (capacity "
            "overwrite).", "counter",
            [({"host": h}, float(v)) for h, v in enumerate(ring_dropped)])
    if flag_ticks is not None:
        flag_ticks = to_host(flag_ticks)
        H, T, K = flag_ticks.shape
        lines += prom_lines(
            f"{prefix}_pathology_flag_ticks_total",
            "Ticks the streaming pathology flag held.", "counter",
            [({"host": h, "tenant": t, "kind": kinds[k]},
              float(flag_ticks[h, t, k]))
             for h in range(H) for t in range(T) for k in range(K)])
    if first_flag is not None:
        first_flag = to_host(first_flag)
        H, T, K = first_flag.shape
        lines += prom_lines(
            f"{prefix}_pathology_first_flag_tick",
            "First tick the streaming pathology flag held (flagged "
            "tenants only).", "gauge",
            [({"host": h, "tenant": t, "kind": kinds[k]},
              float(first_flag[h, t, k]))
             for h in range(H) for t in range(T) for k in range(K)
             if first_flag[h, t, k] >= 0])
    return "\n".join(lines) + "\n"


def rollout_exposition(rollout, prefix: str = "equilibria") -> str:
    """Exposition of a ``fleet_rollout`` RolloutSummary: Counters totals,
    residency histograms, migration-ring wrap accounting, and — when the
    rollout streamed them — the pathology flag counters and the slowdown
    attribution ledger (component/total counters + the fleet stall
    sketch)."""
    counters = rollout.counters()
    det = rollout.final_state.det
    att = rollout.final_state.attrib if rollout.attribution is not None \
        else None
    ring = ring_summary(rollout.final_state.ring)
    return fleet_exposition(
        dict(counters._asdict()),
        resid_hist=rollout.final_state.stats.resid_hist,
        flag_ticks=None if det is None else det.flag_ticks,
        first_flag=None if det is None else det.first_flag,
        stall_components=None if att is None else att.comp,
        stall_totals=None if att is None else att.total,
        stall_sketch=None if att is None else rollout.stall_sketch(),
        ring_events=ring["recorded"], ring_dropped=ring["dropped"],
        prefix=prefix)


def kv_exposition(cache, prefix: str = "equilibria_kv") -> str:
    """Exposition of a serving-path ``TieredKVCache``: the KV tiering
    counters (promotions/demotions/sync demotions/thrash events per
    tenant, host label 0 — one cache per serving host) and its migration
    ring's wrap accounting."""
    from repro_torch.memtier.kvcache import kv_tier_counters  # obs <-> kv
    counters = {k: v[None, :] for k, v in kv_tier_counters(cache).items()}
    ring = ring_summary(cache.ring)
    return fleet_exposition(
        counters,
        ring_events=np.asarray([ring["recorded"]]),
        ring_dropped=np.asarray([ring["dropped"]]),
        prefix=prefix)


def validate_exposition(text: str) -> int:
    """Raise ValueError unless every line of ``text`` matches the Prometheus
    text-format grammar, every sample belongs to a declared metric family,
    and histogram series are cumulative with ``+Inf`` == ``_count``.
    Returns the number of samples validated."""
    declared: Dict[str, str] = {}
    hist_buckets: Dict[str, List[float]] = {}
    hist_counts: Dict[str, float] = {}
    n = 0
    for ln, line in enumerate(text.splitlines(), 1):
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(" ", 3)
            if len(parts) < 4 or parts[1] not in ("HELP", "TYPE"):
                raise ValueError(f"line {ln}: malformed comment {line!r}")
            if parts[1] == "TYPE":
                if parts[3] not in _TYPES:
                    raise ValueError(f"line {ln}: bad type {parts[3]!r}")
                if parts[2] in declared:
                    raise ValueError(f"line {ln}: duplicate TYPE for "
                                     f"{parts[2]!r}")
                declared[parts[2]] = parts[3]
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {ln}: not a valid sample: {line!r}")
        name = m.group("name")
        family = name
        for suffix in ("_bucket", "_sum", "_count"):
            base = name[:-len(suffix)] if name.endswith(suffix) else None
            if base and declared.get(base) == "histogram":
                family = base
        if family not in declared:
            raise ValueError(f"line {ln}: sample {name!r} has no TYPE")
        if declared[family] == "histogram":
            labels = m.group("labels") or ""
            key = family + "|" + re.sub(r'(^|,)le="[^"]*"', "", labels)
            value = float(m.group("value").replace("Inf", "inf"))
            if name.endswith("_bucket"):
                series = hist_buckets.setdefault(key, [])
                if series and value < series[-1]:
                    raise ValueError(f"line {ln}: histogram {key!r} buckets "
                                     "not cumulative")
                series.append(value)
                le = re.search(r'le="([^"]*)"', labels)
                if le is None:
                    raise ValueError(f"line {ln}: _bucket without le label")
                if le.group(1) == "+Inf":
                    hist_counts.setdefault(key, value)
            elif name.endswith("_count"):
                if key in hist_counts and hist_counts[key] != value:
                    raise ValueError(f"line {ln}: histogram {key!r} _count "
                                     "!= +Inf bucket")
        n += 1
    for key in hist_buckets:
        if key not in hist_counts:
            raise ValueError(f"histogram {key!r} missing +Inf bucket")
    return n
