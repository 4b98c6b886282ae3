"""Fleet supervisor: keeps N replica subprocesses alive and warm.

Each replica runs ``python -m paddle_tpu_torch.serving.replica`` with the
fleet spec (written once to a JSON file), the coordination address, and
an inherited environment — including ``PADDLE_COMPILE_CACHE_DIR``, so a
respawn loads its warm-up ladder's step plans and kernel libraries from
the persistent compile cache instead of building them (the whole point
of "warm" respawn).

Death handling is a launcher's restart loop in miniature: a monitor
thread polls the children; any exit while the
supervisor is running gets the replica respawned under the SAME
replica id (its registration key/lease simply gets re-put, and routers
re-dial the fresh endpoint on the next membership refresh), counted in
``fleet_respawn_total``. ``drain(rid)`` sends SIGTERM — the replica's
preemption machinery finishes in-flight batches, releases its lease,
and exits 0 — then respawns warm by default; ``stop()`` SIGTERMs
everything with respawn disabled and reaps.

The supervisor is pure process management: it builds no model and
touches no device, and children start with ``subprocess`` (never a fork
of a process that may hold a CUDA context).
"""

import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

from ..fluid import monitor as _monitor
from ..telemetry import flight as _flight
from . import replica as _replica

__all__ = ["FleetSupervisor"]

_M_RESPAWNS = _monitor.counter(
    "fleet_respawn_total",
    help="replica subprocesses respawned after exiting (crash or "
         "post-drain warm respawn)")


class FleetSupervisor:
    """``FleetSupervisor(spec, n_replicas, coord_addr).start()`` owns
    ``n_replicas`` children until ``stop()``. ``spec`` is the
    ``Replica`` spec dict (shared by every child)."""

    def __init__(self, spec, n_replicas, coord_addr, env=None,
                 python=None, log_dir=None, poll_interval=0.2,
                 flight_dir=None):
        self.spec = dict(spec)
        self.n_replicas = int(n_replicas)
        self.coord_addr = coord_addr
        self._extra_env = dict(env or {})
        self._python = python or sys.executable
        self._log_dir = log_dir or tempfile.mkdtemp(prefix="fleet-logs-")
        os.makedirs(self._log_dir, exist_ok=True)
        # flight-recorder dir exported to every child: a killed/crashed
        # replica leaves flight.<rid>.json here for collect_flight()
        self.flight_dir = flight_dir or os.environ.get(
            _flight.ENV_DIR) or os.path.join(self._log_dir, "flight")
        os.makedirs(self.flight_dir, exist_ok=True)
        self._poll_interval = float(poll_interval)
        self._procs = {}            # rid -> Popen
        self._logs = {}             # rid -> open file handle
        self._no_respawn = set()    # rids drained with respawn=False
        self._mu = threading.Lock()
        self._stopping = threading.Event()
        self._monitor_thread = None
        self._spec_path = None
        self.respawns = 0

    # -- spawning ------------------------------------------------------------
    def _child_env(self, rid):
        env = dict(os.environ)
        env.update(self._extra_env)
        env["PADDLE_COORD_ADDR"] = self.coord_addr
        env[_replica.ENV_SPEC] = self._spec_path
        env[_replica.ENV_REPLICA_ID] = rid
        env[_flight.ENV_DIR] = self.flight_dir
        return env

    def _spawn(self, rid):
        log = open(os.path.join(self._log_dir, "%s.log" % rid), "ab")
        proc = subprocess.Popen(
            [self._python, "-m", "paddle_tpu_torch.serving.replica"],
            stdout=log, stderr=subprocess.STDOUT,
            env=self._child_env(rid))
        old = self._logs.get(rid)
        if old is not None:
            old.close()
        self._logs[rid] = log
        self._procs[rid] = proc
        return proc

    def start(self):
        fd, self._spec_path = tempfile.mkstemp(
            prefix="fleet-spec-", suffix=".json")
        with os.fdopen(fd, "w") as f:
            json.dump(self.spec, f)
        with self._mu:
            for i in range(self.n_replicas):
                self._spawn("rep%d" % i)
        self._monitor_thread = threading.Thread(
            target=self._monitor_loop, daemon=True, name="fleet-sup")
        self._monitor_thread.start()
        return self

    def replica_ids(self):
        with self._mu:
            return sorted(self._procs)

    def pid(self, rid):
        with self._mu:
            return self._procs[rid].pid

    # -- death watch ---------------------------------------------------------
    def _monitor_loop(self):
        while not self._stopping.wait(self._poll_interval):
            with self._mu:
                for rid, proc in list(self._procs.items()):
                    if proc.poll() is None:
                        continue
                    if rid in self._no_respawn:
                        continue
                    # crash OR completed drain: either way the fleet is
                    # down a member — respawn warm under the same id
                    self._spawn(rid)
                    self.respawns += 1
                    _M_RESPAWNS.inc()

    # -- targeted operations -------------------------------------------------
    def kill(self, rid):
        """SIGKILL one replica (the chaos input for the no-loss test);
        the monitor respawns it warm."""
        with self._mu:
            self._procs[rid].kill()

    def drain(self, rid, respawn=True, timeout=30.0):
        """SIGTERM one replica and wait for its graceful exit (finish
        in-flight, release lease, exit 0). ``respawn=False`` scales the
        fleet down instead of cycling the member."""
        with self._mu:
            proc = self._procs[rid]
            if not respawn:
                self._no_respawn.add(rid)
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait(timeout=5)
        return rc

    # -- teardown ------------------------------------------------------------
    def stop(self, timeout=30.0):
        """Drain every replica (SIGTERM, no respawn) and reap."""
        self._stopping.set()
        if self._monitor_thread is not None:
            self._monitor_thread.join(timeout=5)
        with self._mu:
            procs = dict(self._procs)
            self._no_respawn.update(procs)
        for proc in procs.values():
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + timeout
        rcs = {}
        for rid, proc in procs.items():
            left = max(deadline - time.monotonic(), 0.1)
            try:
                rcs[rid] = proc.wait(timeout=left)
            except subprocess.TimeoutExpired:
                proc.kill()
                rcs[rid] = proc.wait(timeout=5)
        for log in self._logs.values():
            log.close()
        self._logs.clear()
        if self._spec_path and os.path.exists(self._spec_path):
            os.unlink(self._spec_path)
        return rcs

    def log_path(self, rid):
        return os.path.join(self._log_dir, "%s.log" % rid)

    # -- postmortem ----------------------------------------------------------
    def collect_flight(self, rid=None):
        """Flight-recorder images the children left behind
        ({rank: image}, or one image / None with ``rid``). A SIGKILLed
        replica's last periodic flush is still here — the postmortem
        shows the spans (including OPEN in-flight ones), monitor deltas,
        and wire ops of its final flush window."""
        images = _flight.collect(self.flight_dir)
        if rid is not None:
            return images.get(str(rid))
        return images
