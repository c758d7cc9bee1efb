"""Fleet-scale plan service: record -> sweep -> merge -> ship -> prewarm
(the port of ``repro.plans``).

The measured autotuner (:mod:`repro_torch.core.autotune`) turns call sites into
tuned plans, but its cache is one private JSON per host, tuned against
whatever shapes happened to run. This package promotes tuning to a managed
artifact pipeline:

* **record** — :func:`record_traffic` captures the real workload
  distribution of a run (serving ``--record-profile``, training, tests)
  into a shape-bucketed :class:`TrafficProfile`;
* **sweep** — :func:`sweep_profile`
  (CLI: ``python -m repro_torch.plans sweep``)
  tunes offline from that profile under a time budget, highest
  frequency x modeled cost first;
* **merge** — :class:`PlanDB` artifacts from heterogeneous hosts combine
  deterministically (newer measurement wins per key, conflicts logged,
  foreign namespaces preserved bitwise);
* **ship + prewarm** — the merged DB rides with a release
  (``REPRO_TORCH_PLAN_DB`` / ``tuning_config(plan_db=...)``); ``autotune``
  consults it after the per-host cache and before measuring, and
  :func:`prewarm` parses it once at startup.

Namespacing (:mod:`repro_torch.plans.registry`) keys records by hardware
fingerprint so one artifact serves a mixed fleet.
"""

from repro_torch.plans.plandb import (      # noqa: F401
    PLANDB_FORMAT_VERSION,
    MergeReport,
    PlanDB,
    PlanDBError,
    content_hash,
    prewarm,
)
from repro_torch.plans.profile import (     # noqa: F401
    PROFILE_FORMAT_VERSION,
    ProfileEntry,
    TrafficProfile,
    bucket_site,
    bucket_value,
    record_traffic,
)
from repro_torch.plans.registry import (    # noqa: F401
    DEFAULT_NAMESPACE,
    hardware_fingerprint,
    plan_namespace,
    register_fingerprint_resolver,
)
from repro_torch.plans.sweep import SweepResult, sweep_profile   # noqa: F401
