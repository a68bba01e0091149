"""Cluster Serving: always-on streaming inference (counterpart of
``analytics_zoo_tpu/serving``; reference serving/ClusterServing.scala:44-230
+ pyzoo/zoo/serving/client.py).

The reference wires Redis streams -> Spark Structured Streaming -> a
broadcast InferenceModel -> Redis result hashes.  Here a single host
process pulls micro-batches from a stream broker, runs them through the
pooled, bucketed
:class:`~analytics_zoo_tpu_torch.pipeline.inference.InferenceModel` (one
captured CUDA graph per bucket on the card), and writes results back.
The broker is pluggable: in-memory (tests/embedded), file-spool
(multi-process, no external service), or Redis when the ``redis``
package is importable — same stream/hash data model in all three.

The fleet plane sits on top: :class:`~analytics_zoo_tpu_torch.serving.fleet
.FleetController` supervises N replicas against one broker and ticks an
SLO-aware :class:`~analytics_zoo_tpu_torch.serving.scaler.SloScaler`;
:class:`~analytics_zoo_tpu_torch.serving.router.ModelRouter` runs one fleet
per :class:`~analytics_zoo_tpu_torch.serving.modelspec.ModelSpec` on
per-model streams, and
:class:`~analytics_zoo_tpu_torch.serving.admission.AdmissionController`
sheds overload at the front door (clients see the typed
:class:`~analytics_zoo_tpu_torch.serving.client.ServingRejected`) so
accepted work keeps the exactly-once claim guarantee.  The four load
lazily, as the reference's do, so a process that never touches them
shows no fleet, router or admission panel in ``/varz``.
"""

from .broker import FileBroker, InMemoryBroker, RedisBroker, connect_broker
from .client import InputQueue, OutputQueue, ServingRejected, \
    ServingTimeout, model_stream
from .modelspec import ModelSpec, format_model_specs, parse_model_specs
from .server import ClusterServing, ClusterServingHelper

__all__ = [
    "InMemoryBroker", "FileBroker", "RedisBroker", "connect_broker",
    "InputQueue", "OutputQueue", "ServingTimeout", "ServingRejected",
    "model_stream", "ModelSpec", "parse_model_specs",
    "format_model_specs",
    "ClusterServing", "ClusterServingHelper",
    "FleetController", "SloScaler",
    "ModelRouter", "AdmissionController",
]


def __getattr__(name):
    # the control plane loads lazily (PEP 562), as the reference's does
    if name == "FleetController":
        from .fleet import FleetController
        return FleetController
    if name == "SloScaler":
        from .scaler import SloScaler
        return SloScaler
    if name == "ModelRouter":
        from .router import ModelRouter
        return ModelRouter
    if name == "AdmissionController":
        from .admission import AdmissionController
        return AdmissionController
    raise AttributeError(name)
