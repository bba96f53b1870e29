"""The observability plane on the TCP transport (the port of
:mod:`dpwa_tpu.obs`), every facility off by default and free when off:

- :mod:`~dpwa_tpu_torch.obs.trace`: per-stage round spans, the round's
  trace ID riding every served frame so the fetcher's and the server's
  spans join (``tools/trace_report.py``);
- :mod:`~dpwa_tpu_torch.obs.sketch`: a seeded projection of the replica,
  made where the replica lies, riding every frame: the ring's disagreement
  online;
- :mod:`~dpwa_tpu_torch.obs.wire`: the ``DPWT`` trailer that carries both;
- :mod:`~dpwa_tpu_torch.obs.prometheus`: ``/metrics`` over every plane;
- :mod:`~dpwa_tpu_torch.obs.incidents`: detectors folded into incidents,
  served at ``/incidents``;
- :mod:`~dpwa_tpu_torch.obs.recorder`: the flight recorder, dumped on a
  crash, an incident, a close or ``/flightdump``.
"""

from dpwa_tpu_torch.obs.incidents import IncidentPlane
from dpwa_tpu_torch.obs.prometheus import MetricsRegistry
from dpwa_tpu_torch.obs.recorder import FlightRecorder
from dpwa_tpu_torch.obs.sketch import SketchBoard, replica_sketch
from dpwa_tpu_torch.obs.trace import Tracer
from dpwa_tpu_torch.obs.wire import ObsFrame, decode_obs, encode_obs

__all__ = [
    "FlightRecorder", "IncidentPlane", "MetricsRegistry", "ObsFrame", "SketchBoard",
    "Tracer", "decode_obs", "encode_obs", "replica_sketch",
]
