"""A pull-based metrics registry with Prometheus text exposition (the port
of :mod:`dpwa_tpu.obs.prometheus`, byte for byte).

Planes keep their own counters and snapshots, so the registry holds
collector callbacks that read them at scrape time: registering a plane
costs nothing a round.  Each plane module has ``register_metrics(registry,
obj)``, and :meth:`~dpwa_tpu_torch.parallel.tcp.TcpTransport._register_metrics`
wires every plane that runs.  The text is exposition format 0.0.4, served
at ``/metrics`` on the healthz port with ``obs.metrics``.  A collector that
raises is skipped for that scrape.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable, List, Mapping, Optional, Tuple

Sample = Tuple[Optional[Mapping[str, object]], object]


class Family:
    """One metric family: name, type, help, and its samples."""

    def __init__(self, name: str, mtype: str, help: str):
        self.name = name
        self.mtype = mtype  # "counter" | "gauge" | "histogram" | "untyped"
        self.help = help
        self.samples: List[Sample] = []

    def sample(self, value: object, labels: Optional[Mapping[str, object]] = None) -> "Family":
        self.samples.append((labels, value))
        return self


Collector = Callable[[], Iterable[Family]]


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _fmt_value(v: object) -> Optional[str]:
    if v is None:
        return None
    if isinstance(v, bool):
        return "1" if v else "0"
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    if f != f:
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class MetricsRegistry:
    """Holds collector callbacks; renders them on demand."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._collectors: List[Collector] = []

    def register(self, collector: Collector) -> None:
        with self._lock:
            self._collectors.append(collector)

    def gauge_fn(self, name: str, help: str, fn: Callable[[], object],
                 mtype: str = "gauge") -> None:
        """A one-sample family backed by a callable."""
        self.register(lambda: [Family(name, mtype, help).sample(fn())])

    def collect(self) -> List[Family]:
        with self._lock:
            collectors = list(self._collectors)
        fams: List[Family] = []
        for c in collectors:
            try:
                fams.extend(c())
            except Exception:  # a broken snapshot degrades one scrape
                continue
        return fams

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        seen_header = set()
        for fam in self.collect():
            if fam.name not in seen_header:
                seen_header.add(fam.name)
                lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
                lines.append(f"# TYPE {fam.name} {fam.mtype}")
            for labels, value in fam.samples:
                val = _fmt_value(value)
                if val is None:
                    continue
                if labels:
                    lbl = ",".join(f'{k}="{_escape_label(str(v))}"'
                                   for k, v in sorted(labels.items()))
                    lines.append(f"{fam.name}{{{lbl}}} {val}")
                else:
                    lines.append(f"{fam.name} {val}")
        return "\n".join(lines) + "\n"
