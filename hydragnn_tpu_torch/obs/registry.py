"""Process-wide metrics registry: the single publication point of the
port's telemetry plane.

Every subsystem (the training loop's step telemetry, the server, the
guard, the checkpoint writer, the event log) publishes into one typed,
labeled namespace that every sink (the versioned ``metrics.jsonl``
stream, the Prometheus endpoint; obs/telemetry.py, obs/prometheus.py)
renders from. The metric names, labels and default buckets are those of
``hydragnn_tpu.obs.registry``, so one scrape config reads both packages.

Design points:

- **stdlib-only and lock-cheap**: publishing is a dict write under one
  process lock; subsystems publish unconditionally (the registry is the
  plane), sinks are opt-in (``Telemetry`` config / ``Serving.http_port``).
- **Prometheus-shaped**: three instrument types (counter / gauge /
  histogram with cumulative buckets), label sets as frozen key-value
  tuples, metric names validated against the exposition grammar at
  registration so a typo fails at wiring time, not scrape time.
- **absorbing counters**: much of this repo's accounting already exists as
  monotonic totals maintained elsewhere (guard ``skipped_steps`` rides the
  TrainState, the validator keeps per-reason counts). ``Counter.set_total`` publishes such an
  external total without double counting — it only ever moves the sample
  up (max-merge), so absorption at every epoch boundary is idempotent.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# label values as a canonical, hashable key
LabelKey = Tuple[Tuple[str, str], ...]

# default histogram buckets: latency-shaped, sub-ms to a wedged minute
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def _label_key(labelnames: Sequence[str], labels: Dict[str, object]) -> LabelKey:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} do not match declared labelnames "
            f"{sorted(labelnames)}"
        )
    return tuple((n, str(labels[n])) for n in labelnames)


class _Metric:
    """Shared bookkeeping of one named instrument (any type)."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str],
                 lock):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r} on {name}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock

    def samples(self) -> List[Tuple[str, LabelKey, float]]:
        """[(suffix, labels, value)] — suffix is "" for scalar instruments,
        "_bucket"/"_sum"/"_count" (+ an extra ``le`` label) for histograms."""
        raise NotImplementedError


class Counter(_Metric):
    """Monotonic total. ``inc`` adds; ``set_total`` max-merges an externally
    maintained monotonic total (idempotent absorption)."""

    kind = "counter"

    def __init__(self, *args):
        super().__init__(*args)
        self._values: Dict[LabelKey, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({amount})")
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + float(amount)

    def set_total(self, total: float, **labels) -> None:
        """Publish an external monotonic total: the sample only moves up,
        so absorbing the same total twice is a no-op."""
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._values[key] = max(self._values.get(key, 0.0), float(total))

    def value(self, **labels) -> float:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def samples(self):
        with self._lock:
            return [("", k, v) for k, v in self._values.items()]


class Gauge(_Metric):
    """Point-in-time value (queue depth, padding waste, MFU estimate)."""

    kind = "gauge"

    def __init__(self, *args):
        super().__init__(*args)
        self._values: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels) -> None:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._values[key] = float(value)

    def set_default(self, value: float, **labels) -> None:
        """Materialize the series at ``value`` only if it has no sample yet
        — constructors use this so a second publisher instance in the same
        process cannot clobber a live one's state just by existing."""
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._values.setdefault(key, float(value))

    def value(self, **labels) -> float:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            return self._values.get(key, math.nan)

    def remove(self, **labels) -> None:
        """Drop one label-set's series entirely (the fleet collector
        retires aggregates whose only contributors went stale — a frozen
        last value scraping forever is indistinguishable from a live
        reading). No-op when the series never existed."""
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._values.pop(key, None)

    def samples(self):
        with self._lock:
            return [("", k, v) for k, v in self._values.items()]


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics): per-label-set
    bucket counts, observation sum, and count. p50/p99 come out of the
    bucket CDF on the scrape side."""

    kind = "histogram"

    def __init__(self, name, help, labelnames, lock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames, lock)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError(f"histogram {name} needs at least one bucket")
        self.buckets = bs
        # per label-set: [counts per finite bucket] + overflow, sum, count
        self._data: Dict[LabelKey, Tuple[List[int], List[float]]] = {}

    def observe(self, value: float, **labels) -> None:
        key = _label_key(self.labelnames, labels)
        v = float(value)
        with self._lock:
            counts, agg = self._data.setdefault(
                key, ([0] * (len(self.buckets) + 1), [0.0, 0.0])
            )
            for i, b in enumerate(self.buckets):
                if v <= b:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            agg[0] += v
            agg[1] += 1.0

    def snapshot(self, **labels) -> Dict[str, float]:
        """{count, sum} plus cumulative counts keyed by upper bound."""
        key = _label_key(self.labelnames, labels)
        with self._lock:
            counts, agg = self._data.get(
                key, ([0] * (len(self.buckets) + 1), [0.0, 0.0])
            )
            out: Dict[str, float] = {"sum": agg[0], "count": agg[1]}
            cum = 0
            for b, c in zip(self.buckets, counts):
                cum += c
                out[str(b)] = float(cum)
            out["+Inf"] = float(cum + counts[-1])
            return out

    def samples(self):
        out: List[Tuple[str, LabelKey, float]] = []
        with self._lock:
            for key, (counts, agg) in self._data.items():
                cum = 0
                for b, c in zip(self.buckets, counts):
                    cum += c
                    out.append(("_bucket", key + (("le", repr(float(b))),),
                                float(cum)))
                out.append(
                    ("_bucket", key + (("le", "+Inf"),),
                     float(cum + counts[-1]))
                )
                out.append(("_sum", key, agg[0]))
                out.append(("_count", key, agg[1]))
        return out


class MetricsRegistry:
    """Named instrument table. ``counter``/``gauge``/``histogram`` are
    get-or-create: re-declaring an existing name returns the existing
    instrument (so publishers in different modules can declare locally),
    but a type or label mismatch fails loudly — two subsystems silently
    disagreeing about a metric's shape is a catalog bug."""

    def __init__(self):
        # RLock, not Lock: publishers run from signal handlers too (the
        # serve drain hook flips the ready gauge) — a handler interrupting
        # its own thread mid-publish must be able to re-acquire. Every
        # guarded mutation is a single dict store/add, so re-entry cannot
        # observe torn state.
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Sequence[str], **kw) -> _Metric:
        with self._lock:
            have = self._metrics.get(name)
            if have is not None:
                if type(have) is not cls or have.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{have.kind}{list(have.labelnames)}; cannot "
                        f"re-declare as {cls.kind}{list(labelnames)}"
                    )
                want_buckets = kw.get("buckets")
                if want_buckets is not None and tuple(
                    sorted(float(b) for b in want_buckets)
                ) != have.buckets:
                    # same loud-mismatch contract as type/labels: bucket
                    # bounds silently inherited from an earlier declaration
                    # would make scrape-side p50/p99 lie about what the
                    # publisher chose
                    raise ValueError(
                        f"histogram {name!r} already registered with buckets "
                        f"{have.buckets}; cannot re-declare with "
                        f"{tuple(want_buckets)}"
                    )
                return have
            m = cls(name, help, tuple(labelnames), self._lock, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def collect(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def reset(self) -> None:
        """Drop every instrument (tests; a long-lived process keeps them)."""
        with self._lock:
            self._metrics.clear()


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide registry every subsystem publishes into."""
    return _REGISTRY
