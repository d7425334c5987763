"""Serving layer of the port above the disaggregated engine
(``repro.runtime.serving``):

- :mod:`workload` — seeded requests from prompt- and output-length
  distributions, and the request lifecycle;
- :mod:`admission` — SLO-aware admission (target TPS/user, TTFT budget,
  queue limit) and evict-to-queue on a sustained violation;
- :mod:`scheduler` — the continuous-batching scheduler of one replica
  (``epoch_mode`` keeps fixed-slot epochs for comparison);
- :mod:`replicas` — independent replicas behind a least-loaded router;
- :mod:`live` — the replica client over live servers (``launch/serve.py
  --serving``).

The JAX package's roofline-modelled client (``modeled``) comes with the
port of its cost model and cluster simulator.
"""
from repro_torch.runtime.serving.admission import (  # noqa: F401
    ADMIT, QUEUE, REJECT, AdmissionController, SLOConfig,
)
from repro_torch.runtime.serving.live import LiveReplicaClient, RoutedTraceRecorder  # noqa: F401
from repro_torch.runtime.serving.replicas import MultiReplicaEngine, ReplicaRouter  # noqa: F401
from repro_torch.runtime.serving.scheduler import ServingScheduler  # noqa: F401
from repro_torch.runtime.serving.workload import (  # noqa: F401
    ServedRequest, WorkloadConfig, synthesize_workload,
)
