"""Serving fleet: multi-process SLO-aware serving over the coordination
service, the port's copy of ``paddle_tpu/serving/`` (the same wire
protocol, KV layout and registration blob). On one card its replicas
are processes that share the device by time slicing.

    client --(wire/TCP)--> Router --(wire/TCP)--> Replica x N
                              \\                     |
                               +---- CoordServer ---+
                                 (leases + KV gauges)

* ``Replica`` (``replica.py``) — wraps the in-process dynamic batcher,
  cold-starts with zero live compiles from ``__prelowered__/`` + the
  persistent compile cache, self-registers under a TTL lease, publishes
  load gauges, drains on SIGTERM.
* ``Router`` (``router.py``) — discovers replicas via
  ``live_members``, balances on published queue depth + local
  in-flight, re-dispatches around dead replicas, sheds over-deadline
  requests typed.
* ``FleetSupervisor`` (``supervisor.py``) — spawns/respawns replica
  subprocesses warm.
* ``FleetClient`` (``client.py``) — the client SDK.

Everything TCP rides ``distributed/wire.py``; every signal rides
``distributed/preemption.py``.
"""

from . import protocol
from .client import FleetClient
from .replica import Replica
from .router import Router
from .supervisor import FleetSupervisor

__all__ = ["protocol", "FleetClient", "Replica", "Router",
           "FleetSupervisor"]
