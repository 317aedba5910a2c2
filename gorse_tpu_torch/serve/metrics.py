"""Prometheus-style metrics (``MetricsRegistry`` of gorse_tpu/serve/metrics.py):
gauges, counters and histograms rendered in the text exposition format."""

from __future__ import annotations

import threading


class MetricsRegistry:
    """Minimal Prometheus-style registry."""

    def __init__(self, namespace: str = "gorse_tpu") -> None:
        self.namespace = namespace
        self._lock = threading.Lock()
        self._values: dict[tuple[str, tuple], float] = {}
        self._types: dict[str, str] = {}
        self._help: dict[str, str] = {}
        self._hist: dict[tuple[str, tuple], list] = {}
        self._buckets: dict[str, tuple] = {}
        # raw observation ring per histogram key (overwrite-oldest at
        # raw_cap), for exact sub-bucket quantiles
        self._raw: dict[tuple[str, tuple], list] = {}
        self._raw_pos: dict[tuple[str, tuple], int] = {}
        self.raw_cap = 100_000

    def _key(self, name: str, labels: dict | None):
        return (name, tuple(sorted((labels or {}).items())))

    def gauge_set(self, name: str, value: float, labels: dict | None = None, help: str = "") -> None:
        with self._lock:
            self._types[name] = "gauge"
            if help:
                self._help[name] = help
            self._values[self._key(name, labels)] = float(value)

    def counter_inc(self, name: str, value: float = 1.0, labels: dict | None = None, help: str = "") -> None:
        with self._lock:
            self._types[name] = "counter"
            if help:
                self._help[name] = help
            k = self._key(name, labels)
            self._values[k] = self._values.get(k, 0.0) + value

    def observe_seconds(self, name: str, seconds: float, labels: dict | None = None) -> None:
        """Record a duration as a <name>_seconds gauge."""
        self.gauge_set(name + "_seconds", seconds, labels)

    # prometheus.DefBuckets
    DEF_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

    def histogram_observe(
        self,
        name: str,
        value: float,
        labels: dict | None = None,
        buckets: tuple = DEF_BUCKETS,
    ) -> None:
        """Cumulative ``_bucket{le=}`` counters plus ``_sum``/``_count``."""
        with self._lock:
            self._types[name] = "histogram"
            self._buckets[name] = buckets
            k = self._key(name, labels)
            counts, total = self._hist.setdefault(k, [[0] * (len(buckets) + 1), 0.0])
            # non-cumulative per-bucket tallies; render() cumulates
            for i, le in enumerate(buckets):
                if value <= le:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1  # above every finite bucket
            self._hist[k] = [counts, total + value]
            raw = self._raw.setdefault(k, [])
            if len(raw) < self.raw_cap:
                raw.append(value)
            else:
                pos = self._raw_pos.get(k, 0)
                raw[pos] = value
                self._raw_pos[k] = (pos + 1) % self.raw_cap

    def histogram_raw(self, name: str) -> dict[tuple, list]:
        """Raw observed values per label set for histogram ``name``."""
        with self._lock:
            return {
                labels: list(vals)
                for (n, labels), vals in self._raw.items()
                if n == name
            }

    def render(self) -> str:
        with self._lock:
            lines = []
            by_name: dict[str, list] = {}
            for (name, labels), value in sorted(self._values.items()):
                by_name.setdefault(name, []).append((labels, value))
            for name, entries in by_name.items():
                full = f"{self.namespace}_{name}"
                if name in self._help:
                    lines.append(f"# HELP {full} {self._help[name]}")
                lines.append(f"# TYPE {full} {self._types.get(name, 'gauge')}")
                for labels, value in entries:
                    if labels:
                        label_str = ",".join(f'{k}="{v}"' for k, v in labels)
                        lines.append(f"{full}{{{label_str}}} {value}")
                    else:
                        lines.append(f"{full} {value}")
            hist_by_name: dict[str, list] = {}
            for (name, labels), (counts, total) in sorted(self._hist.items()):
                hist_by_name.setdefault(name, []).append((labels, counts, total))
            for name, entries in hist_by_name.items():
                full = f"{self.namespace}_{name}"
                lines.append(f"# TYPE {full} histogram")
                buckets = self._buckets[name]
                for labels, counts, total in entries:
                    base = ",".join(f'{k}="{v}"' for k, v in labels)
                    cum = 0
                    sep = "," if base else ""
                    for i, le in enumerate(buckets):
                        cum += counts[i]
                        lines.append(f'{full}_bucket{{{base}{sep}le="{le}"}} {cum}')
                    n_total = cum + counts[-1]
                    lines.append(f'{full}_bucket{{{base}{sep}le="+Inf"}} {n_total}')
                    lbl = f"{{{base}}}" if base else ""
                    lines.append(f"{full}_sum{lbl} {total}")
                    lines.append(f"{full}_count{lbl} {n_total}")
            return "\n".join(lines) + "\n"
