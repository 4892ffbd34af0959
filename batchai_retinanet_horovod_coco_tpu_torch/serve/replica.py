"""Replica handles: one surface over in-process and remote servers; the JAX
package's ``serve/replica.py`` for the port.

The fleet router (``serve/fleet.py``) speaks to every replica through this
interface and never cares whether the ``DetectionServer`` lives in this
process or behind the serve command line's HTTP frontend in another:

- ``replica_id`` / ``version`` — stable identity (the router and the
  canary gate attribute health and weight by it; the fields ride in every
  ``/healthz`` 200 payload's ``load`` block);
- ``healthz()`` — ``(status_code, payload)``; anything but 200 is a
  breaker signal.  A network failure is code 0 (the poller treats it like
  a 503; it never raises out of the poll loop);
- ``detect(payload, timeout_s)`` — one blocking request.  The error
  taxonomy is the serve frontend's (``RequestRejected`` with a reason,
  ``RequestTimeout``) plus ``ReplicaUnavailable`` for "this replica is
  dead or unreachable", the one case the router re-dispatches.

``spawn_http_replica`` forks the serve command line (``python -m
batchai_retinanet_horovod_coco_tpu_torch.serve``) on a pinned port, on the
card unless ``device`` says otherwise (a stub replica needs no device), and
waits for its ``/healthz`` with the shared backoff policy; a replica that
never becomes healthy raises ``ReplicaUnavailable``.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import urllib.error
import urllib.request

from batchai_retinanet_horovod_coco_tpu_torch.obs import telemetry, trace
from batchai_retinanet_horovod_coco_tpu_torch.serve.common import (
    RequestRejected,
    RequestTimeout,
    ServeError,
    ServerClosed,
    ServerError,
)
from batchai_retinanet_horovod_coco_tpu_torch.utils.backoff import BackoffPolicy


class ReplicaUnavailable(ServeError):
    """This replica cannot take the request (dead process, refused
    connection, crashed worker): the error that opens the breaker AT ONCE
    on the request path and triggers re-dispatch.  (A replica-level shed
    is also retried once on another replica, but trips the breaker only
    after a consecutive run; a timeout is a request outcome, never a
    replica death.)"""


class LocalReplica:
    """A ``DetectionServer`` in this process.

    ``healthz`` mirrors the HTTP frontend's verdict: the process-wide
    watchdog verdict (all in-process replicas share one process, hence one
    watchdog), 503 when this server has crashed or stopped accepting, and
    the server's ``load_fields()`` as the ``load`` block either way.
    """

    def __init__(self, server):
        self._server = server
        self._stream = None

    @property
    def server(self):
        return self._server

    @property
    def replica_id(self) -> str:
        return self._server.replica_id

    @property
    def version(self) -> str:
        return getattr(self._server.engine, "version", "live")

    def healthz(self) -> tuple[int, dict]:
        load = self._server.load_fields()
        if self._server._error is not None:
            return 503, {"status": "crashed", "load": load}
        if not load.get("accepting", False):
            return 503, {"status": "draining", "load": load}
        code, payload = telemetry.healthz()
        payload["load"] = load
        return code, payload

    def detect(
        self,
        payload,
        timeout_s: float | None = None,
        trace_id: str | None = None,
    ) -> list[dict]:
        try:
            fut = self._server.submit(payload, timeout_s=timeout_s, trace_id=trace_id)
            return fut.result(timeout=timeout_s)
        except (ServerClosed, ServerError) as exc:
            raise ReplicaUnavailable(f"replica {self.replica_id} unavailable: {exc}") from exc
        except TimeoutError as exc:  # the future's wait expired
            raise RequestTimeout(str(exc)) from exc

    # ---- streaming sessions ----------------------------------------------

    @property
    def stream_manager(self):
        """This replica's ``StreamManager``, made on first streaming use
        (single-image fleets never start its delivery thread)."""
        if self._stream is None:
            from batchai_retinanet_horovod_coco_tpu_torch.serve.stream import StreamManager

            self._stream = StreamManager(self._server)
        return self._stream

    def stream_open(
        self,
        width: int | None = None,
        height: int | None = None,
        trace_id: str | None = None,
    ) -> dict:
        try:
            return self.stream_manager.open_stream(width=width, height=height, trace_id=trace_id)
        except (ServerClosed, ServerError) as exc:
            raise ReplicaUnavailable(f"replica {self.replica_id} unavailable: {exc}") from exc

    def stream_frame(
        self,
        session_id: str,
        seq: int,
        payload,
        timeout_s: float | None = None,
        trace_id: str | None = None,
    ) -> tuple[list[dict], bool]:
        try:
            fut = self.stream_manager.submit_frame(
                session_id, seq, payload, timeout_s=timeout_s, trace_id=trace_id,
            )
            return fut.result(timeout=timeout_s), bool(fut.cache_hit)
        except (ServerClosed, ServerError) as exc:
            raise ReplicaUnavailable(f"replica {self.replica_id} unavailable: {exc}") from exc
        except TimeoutError as exc:  # the future's wait expired
            raise RequestTimeout(str(exc)) from exc

    def stream_close(self, session_id: str) -> dict:
        try:
            return self.stream_manager.close_stream(session_id)
        except (ServerClosed, ServerError) as exc:
            raise ReplicaUnavailable(f"replica {self.replica_id} unavailable: {exc}") from exc

    def metrics_text(self) -> str | None:
        """This replica's Prometheus exposition (the federation scrape
        surface; the payload the HTTP frontend's /metrics serves).  None =
        unscrapable this sweep, never raises: a closed or crashed server
        reports None as a dead HTTP replica would, so a frozen exposition
        drops from the federated view."""
        srv = self._server
        if srv._error is not None or getattr(srv, "_closed", False):
            return None
        try:
            return srv.telemetry.prometheus_text()
        except Exception:
            return None

    def drain(self, timeout_s: float = 5.0) -> None:
        """Stop accepting, let in-flight requests finish (bounded) — the
        canary rollback path.  Further submits shed ``shutting_down``."""
        self._server.close(drain=True, timeout_s=timeout_s)

    def close(self) -> None:
        if self._stream is not None:
            self._stream.close()
        self._server.close(drain=False)


class HttpReplica:
    """A replica behind the serve command line's HTTP frontend.

    Identity is learned from the first healthy ``/healthz`` payload (its
    ``load.replica_id`` / ``load.version`` fields) and kept afterwards;
    until then the constructor's fallbacks hold.
    """

    def __init__(
        self,
        base_url: str,
        replica_id: str | None = None,
        version: str = "unknown",
        timeout_s: float = 10.0,
        health_timeout_s: float = 2.5,
    ):
        self.base_url = base_url.rstrip("/")
        self._replica_id = replica_id or self.base_url
        self._version = version
        self._timeout_s = timeout_s
        # Health probes get a TIGHTER bound than requests: the fleet
        # poller sweeps replicas serially, so one black-holed host must not
        # starve the whole fleet's weight updates for timeout_s.
        self._health_timeout_s = min(health_timeout_s, timeout_s)

    @property
    def replica_id(self) -> str:
        return self._replica_id

    @property
    def version(self) -> str:
        return self._version

    def healthz(self) -> tuple[int, dict]:
        try:
            with urllib.request.urlopen(
                f"{self.base_url}/healthz", timeout=self._health_timeout_s
            ) as r:
                payload = json.loads(r.read().decode())
                code = r.status
        except urllib.error.HTTPError as e:  # 503 is data, not an error
            try:
                payload = json.loads(e.read().decode())
            except Exception:
                payload = {}
            code = e.code
        except Exception as e:  # refused / reset / timeout: a poller signal
            return 0, {"status": "unreachable", "error": repr(e)}
        load = payload.get("load") or {}
        if code == 200 and load.get("replica_id"):
            self._replica_id = str(load["replica_id"])
            self._version = str(load.get("version") or self._version)
        return code, payload

    def _post(
        self,
        path: str,
        data: bytes,
        headers: dict,
        timeout_s: float | None,
        trace_id: str | None,
        rejected_codes: tuple[int, ...],
    ) -> dict:
        """POST one request; the serve taxonomy from the status code:
        ``rejected_codes`` → ``RequestRejected(reason)``, 504 →
        ``RequestTimeout``, any other error → ``ReplicaUnavailable``.  A
        socket timeout is a SLOW replica, not a dead one: a request
        outcome, never a breaker hit, never re-dispatched while the
        original may still run.  Refused or reset is dead."""
        req = urllib.request.Request(f"{self.base_url}{path}", data=data, method="POST")
        for k, v in headers.items():
            req.add_header(k, v)
        if trace_id is not None:
            # The cross-process span context: the replica frontend parents
            # its serve_request span under this id.
            req.add_header(trace.TRACE_HEADER, trace_id)
        timeout = self._timeout_s if timeout_s is None else timeout_s
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return json.loads(r.read().decode())
        except urllib.error.HTTPError as e:
            body = {}
            try:
                body = json.loads(e.read().decode())
            except Exception:
                pass
            if e.code in rejected_codes:
                raise RequestRejected(str(body.get("reason", "rejected"))) from e
            if e.code == 504:
                raise RequestTimeout("replica deadline exceeded") from e
            raise ReplicaUnavailable(f"replica {self.replica_id} HTTP {e.code}") from e
        except Exception as e:
            if isinstance(e, TimeoutError) or isinstance(getattr(e, "reason", None), TimeoutError):
                raise RequestTimeout(f"replica {self.replica_id} timed out") from e
            raise ReplicaUnavailable(f"replica {self.replica_id} unreachable: {e!r}") from e

    def detect(
        self,
        payload,
        timeout_s: float | None = None,
        trace_id: str | None = None,
    ) -> list[dict]:
        if not isinstance(payload, (bytes, bytearray, memoryview)):
            raise RequestRejected("decode_error", "HTTP replicas take encoded image bytes")
        out = self._post("/detect", bytes(payload), {}, timeout_s, trace_id, (400, 503))
        return out["detections"]

    # ---- streaming sessions ----------------------------------------------
    # detect()'s mapping plus 404: an unknown session is ``unknown_stream``,
    # a re-open signal, never a breaker hit.

    def stream_open(
        self,
        width: int | None = None,
        height: int | None = None,
        trace_id: str | None = None,
    ) -> dict:
        spec = {}
        if width:
            spec["width"] = int(width)
        if height:
            spec["height"] = int(height)
        return self._post("/stream/open", json.dumps(spec).encode(), {}, None, trace_id,
                          (400, 404, 503))

    def stream_frame(
        self,
        session_id: str,
        seq: int,
        payload,
        timeout_s: float | None = None,
        trace_id: str | None = None,
    ) -> tuple[list[dict], bool]:
        if not isinstance(payload, (bytes, bytearray, memoryview)):
            raise RequestRejected("decode_error", "HTTP replicas take encoded frame bytes")
        headers = {"X-Retinanet-Stream": session_id, "X-Retinanet-Frame": str(int(seq))}
        if timeout_s is not None:
            headers["X-Retinanet-Deadline-Ms"] = str(timeout_s * 1e3)
        out = self._post("/stream/frame", bytes(payload), headers, timeout_s, trace_id,
                         (400, 404, 503))
        return out["detections"], bool(out.get("cache_hit", False))

    def stream_close(self, session_id: str) -> dict:
        out = self._post("/stream/close", b"", {"X-Retinanet-Stream": session_id}, None, None,
                         (400, 404, 503))
        return out.get("stats", {})

    def metrics_text(self) -> str | None:
        """GET /metrics — the federation scrape surface, under the health
        probe's timeout (the scrape sweep is serial, like the health
        poll); None on any failure, never raises."""
        try:
            with urllib.request.urlopen(
                f"{self.base_url}/metrics", timeout=self._health_timeout_s
            ) as r:
                return r.read().decode()
        except Exception:
            return None

    def drain(self, timeout_s: float = 5.0) -> None:
        # No remote admin surface: "drain" for an HTTP replica is the
        # router holding its weight at zero while in-flight work finishes
        # under the frontend's own drain contract.
        pass

    def close(self) -> None:
        pass


class RespawnBudget:
    """Budgeted respawn supervision for ONE replica slot.

    Each death schedules the next respawn on the policy's
    deterministic-jitter backoff (``delay_s(deaths-1)``), and once deaths
    exceed ``max_tries`` without an intervening recovery the slot is
    EXHAUSTED: the supervisor emits ``respawn_budget_exhausted`` once and
    leaves the slot to the autoscaler.  A replica that stays alive
    ``reset_after_s`` past its last death earns a fresh budget.

    Pure state machine on an injectable clock — no sleeping, no threads;
    the supervision loop drives it.
    """

    def __init__(self, policy: BackoffPolicy, reset_after_s: float = 60.0):
        self.policy = policy
        self.reset_after_s = reset_after_s
        self.deaths = 0
        self.exhausted = False
        self.next_respawn_t = 0.0
        self._last_death_t: float | None = None

    def note_alive(self, now: float) -> None:
        """The replica is up: reset the budget once it has survived
        ``reset_after_s`` past the last death."""
        if (
            self.deaths
            and not self.exhausted
            and self._last_death_t is not None
            and now - self._last_death_t >= self.reset_after_s
        ):
            self.deaths = 0
            self._last_death_t = None

    def note_death(self, now: float) -> bool:
        """Record one death.  Returns True when a respawn is still in
        budget (``next_respawn_t`` holds when); False = exhausted."""
        if (
            self.deaths
            and self._last_death_t is not None
            and now - self._last_death_t >= self.reset_after_s
        ):
            self.deaths = 0  # long-lived replica: fresh budget
        self._last_death_t = now
        self.deaths += 1
        if self.deaths > self.policy.max_tries:
            self.exhausted = True
            return False
        self.next_respawn_t = now + self.policy.delay_s(self.deaths - 1)
        return True

    def ready(self, now: float) -> bool:
        return not self.exhausted and now >= self.next_respawn_t


def release_subprocess(
    proc: subprocess.Popen,
    sigterm_timeout_s: float = 10.0,
) -> int | None:
    """Drain-aware subprocess release: SIGTERM (the serve command line
    maps it to its bounded in-flight drain), a bounded wait, SIGKILL only
    if the drain never finishes.  Returns the exit code (None if even the
    kill's wait expired)."""
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=sigterm_timeout_s)
        except Exception:
            proc.kill()
            try:
                proc.wait(timeout=5)
            except Exception:
                return None
    return proc.returncode


def free_port(host: str = "127.0.0.1") -> int:
    """An OS-assigned free TCP port (bind-0 probe).  A small race window
    lies between close and the child's bind."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def spawn_http_replica(
    replica_id: str,
    port: int | None = None,
    host: str = "127.0.0.1",
    export_dir: str | None = None,
    stub_delay_ms: float | None = None,
    extra_args: list[str] | None = None,
    wait_policy: BackoffPolicy = BackoffPolicy(
        max_tries=120, base_s=0.5, multiplier=1.0, jitter=0.0
    ),
    env: dict | None = None,
    device: str = "cuda",
) -> tuple[subprocess.Popen, "HttpReplica"]:
    """Fork one serve command line replica on a pinned port and wait for
    its health.

    ``export_dir`` replicas serve on ``device`` (``cuda`` unless the
    caller asks for the CPU); ``export_dir=None`` spawns a
    ``--stub-engine`` replica, which needs no device.  The pinned port is
    what lets a breaker-open replica be restarted in place and readmitted
    by the half-open probe.  A replica that exits or never answers
    ``/healthz`` 200 within ``wait_policy`` is killed and raises
    ``ReplicaUnavailable`` with the tail of its standard error.  Returns
    ``(process, HttpReplica)``; the caller owns the process.
    """
    port = free_port(host) if port is None else port
    cmd = [
        sys.executable, "-m", "batchai_retinanet_horovod_coco_tpu_torch.serve",
        "--http", str(port), "--host", host, "--replica-id", replica_id,
    ]
    if export_dir is not None:
        cmd += ["--export-dir", export_dir, "--device", device]
    else:
        cmd += ["--stub-engine"]
        if stub_delay_ms is not None:
            cmd += ["--stub-delay-ms", str(stub_delay_ms)]
    cmd += extra_args or []
    child_env = dict(os.environ)
    # The repository is path-based (not pip-installed): the child resolves
    # the package whatever the caller's working directory.
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    child_env["PYTHONPATH"] = (
        repo_root + os.pathsep + child_env["PYTHONPATH"]
        if child_env.get("PYTHONPATH") else repo_root
    )
    child_env.update(env or {})
    # Standard error goes to an unlinked temporary file: read back only to
    # say why a replica never became healthy.
    with tempfile.TemporaryFile() as errors:
        proc = subprocess.Popen(cmd, env=child_env, stdout=subprocess.DEVNULL, stderr=errors)
        replica = HttpReplica(f"http://{host}:{port}", replica_id=replica_id)

        def probe():
            if proc.poll() is not None:
                return f"replica process exited rc={proc.returncode}"
            code, _payload = replica.healthz()
            return None if code == 200 else f"healthz {code}"

        _attempts, err = wait_policy.retry(probe)
        if err is not None:
            proc.kill()
            proc.wait()
            errors.seek(0)
            tail = errors.read().decode(errors="replace")[-2000:]
            raise ReplicaUnavailable(
                f"spawned replica {replica_id} never became healthy: {err}\n{tail}"
            )
    return proc, replica


__all__ = [
    "HttpReplica",
    "LocalReplica",
    "ReplicaUnavailable",
    "RespawnBudget",
    "free_port",
    "release_subprocess",
    "spawn_http_replica",
]
