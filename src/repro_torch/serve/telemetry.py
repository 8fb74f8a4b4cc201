"""Unified observability plane for the Kotta serving stack.

Cloud Kotta lands job state, audit records, and utilization in one
provisioned DynamoDB table so operators can see, bill, and scale the whole
system from a single backplane (PAPER.md §IV–§V; the Fig-6 saturation
experiment is driven off that telemetry). This module is the serve-side
half of that story:

- :class:`MetricsRegistry` — counters, gauges, and fixed-bucket histograms
  with labels (tenant, replica, job class), Prometheus text exposition
  (:meth:`MetricsRegistry.expose`) and a virtual-clock-aware snapshot API
  (:meth:`MetricsRegistry.snapshot`) whose timestamps come from the
  gateway's virtual clock, so scrapes are
  deterministic across hosts just like the bench numbers.
- :func:`parse_exposition` — a strict parser for the exposition format,
  used by the round-trip test that proves what we serve is what a real
  Prometheus scraper would ingest.
- :class:`RegistryDict` — a write-through ``MutableMapping`` that lets the
  existing ad-hoc stats dicts (``gateway.stats``, ``engine.stats``,
  ``router.stats``) become *views over* registry series without changing a
  single call site: ``stats["shed"] += 1`` still works, and the delta also
  lands on the bound Prometheus counter. Counter-bound keys use **delta
  semantics** (only positive deltas increment the series), so an engine
  ``_reset_stats()`` zeroes the local mirror while the registry counter
  stays monotonic — exactly Prometheus counter-reset behavior.

Design notes
------------
Families are created idempotently: asking for an existing name returns the
existing family (and raises if the kind/labelnames disagree), so gateway,
engines, and router can all bind against one shared registry without
coordination. Collectors (callbacks registered via
:meth:`MetricsRegistry.register_collector`) run at scrape/snapshot time to
refresh gauges computed from live state — per-replica occupancy, queue
depth, SLO burn rate — the standard Prometheus collector pattern.
"""
from __future__ import annotations

import math
from collections.abc import MutableMapping
from typing import Callable, Iterable, Optional

__all__ = ["MetricsRegistry", "RegistryDict", "parse_exposition",
           "LATENCY_BUCKETS_S"]

# Fixed latency buckets (seconds) shared by the TTFT/TPOT/queue-wait
# histograms: log-ish spacing from sub-tick to the longest deadlines the
# benches use.
LATENCY_BUCKETS_S = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                     10.0, 30.0, 60.0, 120.0, 300.0)

_INF = math.inf


def _format_value(v: float) -> str:
    """Lossless float formatting (repr round-trips exactly in Python);
    integral values render bare so ``5`` not ``5.0`` noise — the parser
    reads both."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _unescape_label(v: str) -> str:
    out, i = [], 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            out.append({"\\": "\\", '"': '"', "n": "\n"}.get(nxt, "\\" + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _render_labels(labelnames: tuple, labelvalues: tuple) -> str:
    if not labelnames:
        return ""
    inner = ",".join(f'{n}="{_escape_label(str(v))}"'
                     for n, v in zip(labelnames, labelvalues))
    return "{" + inner + "}"


class _Series:
    """One (family, label-values) time series holding a scalar value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0, got {amount}")
        self.value += amount

    def set(self, value: float) -> None:
        self.value = float(value)


class _HistogramSeries:
    """Cumulative fixed-bucket histogram series (Prometheus semantics:
    ``le`` buckets are cumulative, +Inf bucket == count)."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: tuple):
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)   # last = +Inf overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self.sum += v
        self.count += 1
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def cumulative(self) -> list:
        """Per-``le`` cumulative counts, +Inf last."""
        out, run = [], 0
        for c in self.counts:
            run += c
            out.append(run)
        return out


class _Family:
    """A named metric family: kind + help + labelnames + its series."""

    def __init__(self, name: str, kind: str, help: str, labelnames: tuple,
                 buckets: tuple = ()):
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(float(b) for b in buckets)
        if self.kind == "histogram" and not self.buckets:
            raise ValueError(f"histogram {name!r} needs at least one bucket")
        if list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(f"histogram {name!r} buckets must be strictly "
                             f"increasing: {buckets}")
        self._series: dict[tuple, object] = {}

    # -- series access -------------------------------------------------------
    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} expects labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[n]) for n in self.labelnames)

    def labels(self, **labels):
        key = self._key(labels)
        s = self._series.get(key)
        if s is None:
            s = (_HistogramSeries(self.buckets) if self.kind == "histogram"
                 else _Series())
            self._series[key] = s
        return s

    # -- convenience (no-label or inline-label updates) ----------------------
    def inc(self, amount: float = 1.0, **labels) -> None:
        if self.kind != "counter":
            raise TypeError(f"{self.name!r} is a {self.kind}, not a counter")
        self.labels(**labels).inc(amount)

    def set(self, value: float, **labels) -> None:
        if self.kind != "gauge":
            raise TypeError(f"{self.name!r} is a {self.kind}, not a gauge")
        self.labels(**labels).set(value)

    def observe(self, value: float, **labels) -> None:
        if self.kind != "histogram":
            raise TypeError(f"{self.name!r} is a {self.kind}, "
                            f"not a histogram")
        self.labels(**labels).observe(value)

    def clear(self) -> None:
        """Drop all series (collectors re-set gauges for live objects only,
        so retired replicas stop being exported)."""
        self._series.clear()

    def value(self, **labels) -> float:
        if self.kind == "histogram":
            raise TypeError(f"{self.name!r} is a histogram; read samples "
                            f"via snapshot()/expose()")
        s = self._series.get(self._key(labels))
        return 0.0 if s is None else s.value


class MetricsRegistry:
    """The serve stack's single metrics backplane.

    ``clock`` (any object with ``now()``) stamps snapshots; on the gateway
    this is the shared virtual clock, so two runs
    of the same seeded bench produce byte-identical snapshot streams.
    """

    def __init__(self, clock=None):
        self.clock = clock
        self._families: dict[str, _Family] = {}
        self._collectors: list[Callable[[], None]] = []

    # -- family constructors (idempotent) ------------------------------------
    def _family(self, name: str, kind: str, help: str, labelnames: tuple,
                buckets: tuple = ()) -> _Family:
        fam = self._families.get(name)
        if fam is not None:
            if fam.kind != kind or fam.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}"
                    f"{fam.labelnames}, cannot re-register as {kind}"
                    f"{tuple(labelnames)}")
            return fam
        fam = _Family(name, kind, help, tuple(labelnames), buckets)
        self._families[name] = fam
        return fam

    def counter(self, name: str, help: str = "",
                labelnames: Iterable[str] = ()) -> _Family:
        return self._family(name, "counter", help, tuple(labelnames))

    def gauge(self, name: str, help: str = "",
              labelnames: Iterable[str] = ()) -> _Family:
        return self._family(name, "gauge", help, tuple(labelnames))

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = LATENCY_BUCKETS_S,
                  labelnames: Iterable[str] = ()) -> _Family:
        return self._family(name, "histogram", help, tuple(labelnames),
                            tuple(buckets))

    def register_collector(self, fn: Callable[[], None]) -> None:
        """``fn`` runs before every expose()/snapshot() to refresh gauges
        computed from live state (occupancy, queue depth, burn rate)."""
        self._collectors.append(fn)

    # -- reads ---------------------------------------------------------------
    def collect(self) -> None:
        for fn in self._collectors:
            fn()

    def value(self, name: str, **labels) -> float:
        """Point read of one counter/gauge series (0.0 when unset)."""
        fam = self._families.get(name)
        if fam is None:
            return 0.0
        return fam.value(**labels)

    def families(self) -> list:
        return sorted(self._families)

    def snapshot(self) -> dict:
        """Structured scrape: ``{"ts", "families": {name: {...}}}``.

        Histogram buckets key on the same ``le`` strings the exposition
        renders, so ``parse_exposition(expose())["families"]`` equals
        ``snapshot()["families"]`` exactly (the round-trip contract).
        """
        self.collect()
        fams = {}
        for name in sorted(self._families):
            fam = self._families[name]
            samples = []
            # Sort by the label-item tuple — the same canonical order the
            # parser reconstructs, so round-trip equality is exact.
            ordered = sorted(fam._series,
                             key=lambda k: tuple(sorted(
                                 zip(fam.labelnames, k))))
            for key in ordered:
                s = fam._series[key]
                labels = dict(zip(fam.labelnames, key))
                if fam.kind == "histogram":
                    les = [_format_value(b) for b in fam.buckets] + ["+Inf"]
                    samples.append({
                        "labels": labels,
                        "buckets": dict(zip(les, (float(c) for c in
                                                  s.cumulative()))),
                        "sum": s.sum,
                        "count": float(s.count),
                    })
                else:
                    samples.append({"labels": labels, "value": s.value})
            fams[name] = {"kind": fam.kind, "samples": samples}
        return {"ts": (self.clock.now() if self.clock is not None else 0.0),
                "families": fams}

    def expose(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        self.collect()
        lines = []
        for name in sorted(self._families):
            fam = self._families[name]
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for key in sorted(fam._series):
                s = fam._series[key]
                if fam.kind == "histogram":
                    cum = s.cumulative()
                    les = [_format_value(b) for b in fam.buckets] + ["+Inf"]
                    for le, c in zip(les, cum):
                        lbl = _render_labels(fam.labelnames + ("le",),
                                             key + (le,))
                        lines.append(f"{name}_bucket{lbl} "
                                     f"{_format_value(c)}")
                    lbl = _render_labels(fam.labelnames, key)
                    lines.append(f"{name}_sum{lbl} {_format_value(s.sum)}")
                    lines.append(f"{name}_count{lbl} "
                                 f"{_format_value(s.count)}")
                else:
                    lbl = _render_labels(fam.labelnames, key)
                    lines.append(f"{name}{lbl} {_format_value(s.value)}")
        return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# Exposition parser (round-trip verification)
# ---------------------------------------------------------------------------

def _parse_labels(block: str) -> dict:
    """Parse the inside of a ``{...}`` label block."""
    labels, i, n = {}, 0, len(block)
    while i < n:
        eq = block.index("=", i)
        lname = block[i:eq].strip()
        if block[eq + 1] != '"':
            raise ValueError(f"label value for {lname!r} not quoted")
        j = eq + 2
        raw = []
        while j < n:
            c = block[j]
            if c == "\\":
                raw.append(block[j:j + 2])
                j += 2
                continue
            if c == '"':
                break
            raw.append(c)
            j += 1
        else:
            raise ValueError("unterminated label value")
        labels[lname] = _unescape_label("".join(raw))
        i = j + 1
        if i < n and block[i] == ",":
            i += 1
    return labels


def _parse_value(tok: str) -> float:
    if tok == "+Inf":
        return math.inf
    if tok == "-Inf":
        return -math.inf
    return float(tok)


def parse_exposition(text: str) -> dict:
    """Parse Prometheus text exposition into the :meth:`snapshot` shape
    (minus ``ts``): ``{"families": {name: {"kind", "samples"}}}``.

    Strict on structure (TYPE before samples, histogram series complete
    with ``_sum``/``_count``) — it exists to *verify* the renderer, so it
    fails loudly on anything malformed.
    """
    families: dict[str, dict] = {}
    kinds: dict[str, str] = {}
    # name -> label-key-tuple -> accumulating sample
    acc: dict[str, dict] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("# HELP"):
            continue
        if line.startswith("# TYPE"):
            _, _, name, kind = line.split(None, 3)
            kinds[name] = kind
            acc.setdefault(name, {})
            continue
        if line.startswith("#"):
            continue
        # sample line: name{labels} value  |  name value
        if "{" in line:
            mname = line[:line.index("{")]
            rest = line[line.index("{") + 1:]
            lblock = rest[:rest.rindex("}")]
            vtok = rest[rest.rindex("}") + 1:].split()[0]
            labels = _parse_labels(lblock)
        else:
            mname, vtok = line.split()[:2]
            labels = {}
        value = _parse_value(vtok)
        base, part = mname, "value"
        for suffix in ("_bucket", "_sum", "_count"):
            cand = mname[:-len(suffix)] if mname.endswith(suffix) else None
            if cand is not None and kinds.get(cand) == "histogram":
                base, part = cand, suffix[1:]
                break
        if base not in kinds:
            raise ValueError(f"sample for {mname!r} before its TYPE line")
        le = labels.pop("le", None)
        key = tuple(sorted(labels.items()))
        sample = acc[base].setdefault(key, {"labels": labels})
        if kinds[base] == "histogram":
            if part == "bucket":
                if le is None:
                    raise ValueError(f"{mname}: histogram bucket missing le")
                sample.setdefault("buckets", {})[le] = value
            elif part == "sum":
                sample["sum"] = value
            elif part == "count":
                sample["count"] = value
            else:
                raise ValueError(f"unexpected histogram sample {mname!r}")
        else:
            sample["value"] = value
    for name, kind in kinds.items():
        if kind == "histogram":
            for key, sample in acc[name].items():
                if "sum" not in sample or "count" not in sample:
                    raise ValueError(f"histogram {name!r} series "
                                     f"{dict(key)!r} missing _sum/_count")
        families[name] = {
            "kind": kind,
            "samples": [acc[name][k] for k in sorted(acc[name])],
        }
    return {"families": families}


# ---------------------------------------------------------------------------
# Backed-dict compatibility layer
# ---------------------------------------------------------------------------

class RegistryDict(MutableMapping):
    """A dict whose writes flow through to bound registry series.

    The pre-telemetry serve stack kept counters in plain dicts and both
    tests and benches read them (``eng.stats["admitted"]``,
    ``gw.metrics()["shed"]``). This wrapper preserves every dict behavior
    (iteration, ``.get``, ``+=``, ``dict(...)`` copies) while teeing writes
    into the registry:

    - a key bound to a **counter** series applies *positive deltas* only
      (``stats[k] = new`` increments the series by ``max(new - old, 0)``),
      so local resets never decrement the monotonic series;
    - a key bound to a **gauge** series sets it outright;
    - an unbound key is local-only (scratch accumulators like
      ``accept_ema_sum`` stay out of the exposition).
    """

    def __init__(self):
        self._local: dict = {}
        self._sinks: dict = {}       # key -> (kind, series)

    def bind(self, key: str, family: Optional[_Family], initial: float = 0,
             **labels) -> None:
        """Bind ``key`` to one series of ``family`` (``None`` = local-only)
        and seed the local mirror with ``initial`` (pre-bind totals carry
        into the series so binding mid-life loses nothing)."""
        self._local[key] = initial
        if family is None:
            return
        series = family.labels(**labels)
        self._sinks[key] = (family.kind, series)
        if family.kind == "counter":
            if initial > 0:
                series.inc(initial)
        elif family.kind == "gauge":
            series.set(initial)
        else:
            raise TypeError(f"cannot bind dict key {key!r} to a "
                            f"{family.kind}")

    # -- MutableMapping ------------------------------------------------------
    def __setitem__(self, key, value):
        sink = self._sinks.get(key)
        if sink is not None:
            kind, series = sink
            if kind == "counter":
                delta = value - self._local.get(key, 0)
                if delta > 0:
                    series.inc(delta)
            else:
                series.set(value)
        self._local[key] = value

    def __getitem__(self, key):
        return self._local[key]

    def __delitem__(self, key):
        del self._local[key]
        self._sinks.pop(key, None)

    def __iter__(self):
        return iter(self._local)

    def __len__(self):
        return len(self._local)

    def __repr__(self):
        return f"RegistryDict({self._local!r})"
