"""The flow control plane of the TCP transport (the port of
:mod:`dpwa_tpu.flowctl`), configured by the ``flowctl:`` block
(:class:`dpwa_tpu_torch.config.FlowctlConfig`).

- Fetcher side, :class:`DeadlineEstimator`: each classified fetch feeds a
  per-peer window of success latencies, whose quantile (times a margin,
  clamped) is the next fetch's deadline; once the un-margined quantile
  lapses the transport hedges the fetch to the schedule's fallback partner.
- Serving side, :class:`AdmissionController`: the Rx server sheds excess
  load with a ``DPWB`` busy frame (a connection cap, per-remote token
  buckets, an in-flight-bytes ceiling) and evicts a request that trickles
  in.  A fetcher reads the frame as the low-weight ``busy`` outcome.

Neither holds a reference into the transport; :mod:`~dpwa_tpu_torch.
flowctl.vclock` is their injectable time source.
"""

from dpwa_tpu_torch.flowctl.admission import AdmissionController
from dpwa_tpu_torch.flowctl.estimator import DeadlineEstimator

__all__ = ["AdmissionController", "DeadlineEstimator"]
