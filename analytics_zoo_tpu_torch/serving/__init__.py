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

Not ported yet (ROADMAP queue 1 item 17): the fleet plane —
``FleetController`` (``fleet.py``), ``SloScaler`` (``scaler.py``),
``ModelRouter`` (``router.py``) and ``AdmissionController``
(``admission.py``); reading one of those names raises
``NotImplementedError``.  One ``ClusterServing`` with an ``owner``
already serves in the fleet's claim mode.
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
]

#: the reference's control-plane names (its lazy ``__getattr__``), which
#: wait for ROADMAP queue 1 item 17
UNPORTED = ("FleetController", "SloScaler", "ModelRouter",
            "AdmissionController")


def unported(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"serving.{name} belongs to the serving fleet plane (fleet "
        f"controller, SLO scaler, model router, admission), which the "
        f"port does not have yet (ROADMAP queue 1 item 17)")


def __getattr__(name):
    if name in UNPORTED:
        raise unported(name)
    raise AttributeError(name)
