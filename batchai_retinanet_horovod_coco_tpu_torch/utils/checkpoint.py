"""Crash-safe asynchronous checkpoints in the JAX package's format
(``utils/checkpoint.py`` there), so that a checkpoint moves between the two
packages in both directions.

**Format**: one directory per checkpoint, scanned, never indexed::

    <dir>/ckpt-<step>/
        leaf_00000.npy ...    # the saveable state's leaves, in flatten order
        manifest.json         # written LAST: key paths, shapes, dtypes,
                              # sizes, crc32s, zero_world_size, metadata

The leaves are ``train/state.py::saveable``'s: the key paths and layouts of
the JAX package's ``{step, params, batch_stats, opt_state}``.

**Crash safety**: leaves are written into ``<dir>/.tmp-<step>-<pid>`` and
fsync'd, the manifest is written (and fsync'd) into the tmp dir last, one
``os.rename`` publishes the directory, and the parent is fsync'd after.  A
kill at any instant leaves the previous complete checkpoint or the new one:
a directory without a manifest, or whose manifest disagrees with its files,
is torn, and the scan skips it (one ``ckpt_torn_skipped`` line on stderr)
for the next valid one.

**Asynchronous writes**: ``save()`` copies the state to the host in the
caller's thread, complete before it returns (the next step updates the
parameters in place), and hands the host arrays to one background writer
thread, so the disk write overlaps the next steps.  One behind: a new save
first joins the write in flight, so at most one checkpoint waits in host
memory.  A writer's failure is announced on stderr at once and re-raised at
the next ``save()``, ``wait()`` or ``close()``.  The snapshot and the write
are the ``ckpt_snapshot`` and ``ckpt_write`` spans; the writer heartbeats
as ``ckpt-writer`` and feeds ``obs/telemetry.py``'s checkpoint gauges
(``record_ckpt_save``, ``record_ckpt_inflight``).

**In a data-parallel world** (``world``, ``launch/pod.py::World``) rank 0
alone writes (the others hold the same state) and the manifest's metadata
records the world (``shard_count``, which the command line sets); every rank
restores the step rank 0 chose, and ``wait()`` and ``close()`` end in a
barrier, so no rank reads a step before rank 0's write of it has landed.
The format does not depend on the world: a checkpoint of one world size
restores in another, and in the JAX package.

**Restoring a pod's checkpoint**: a manifest whose ``zero_world_size`` is
set holds each optimizer leaf as a flat zero-padded ``(N * chunk,)`` array
(the JAX package's ZeRO layout); ``restore`` re-lays it into this state's
shape with :func:`reshard_flat_leaf`.  The gradient-compression residuals
of a JAX run (``comm_state``) have no counterpart here and are dropped with
one ``ef_reset`` line, as the JAX package drops them on a layout change.
"""

from __future__ import annotations

import json
import os
import queue
import re
import shutil
import sys
import threading
import zlib
from collections.abc import Mapping
from typing import Any

import numpy as np

from batchai_retinanet_horovod_coco_tpu_torch.obs import telemetry, trace, watchdog
from batchai_retinanet_horovod_coco_tpu_torch.obs.trace import monotonic_s
from batchai_retinanet_horovod_coco_tpu_torch.train import state as state_lib
from batchai_retinanet_horovod_coco_tpu_torch.utils.atomicio import atomic_write_json, fsync_dir

FORMAT = "retinanet-ckpt"
FORMAT_VERSION = 1

_STEP_DIR_RE = re.compile(r"^ckpt-(\d+)$")
_TMP_PREFIX = ".tmp-"
_OPT_PREFIX = "['opt_state']"
_COMM_PREFIX = "['comm_state']"


def reshard_flat_leaf(saved: np.ndarray, shape, dtype, path: str = "") -> np.ndarray:
    """Re-lay one optimizer leaf saved in one ZeRO or replicated layout into
    another (the JAX package's ``parallel/zero.py::reshard_flat_leaf``).

    A leaf is either its parameter's shape (replicated) or a flat
    zero-padded ``(N * chunk,)`` array (world N), whose prefix is the
    content.  So any conversion is: flatten, cut or zero-pad to the target
    size, reshape; it refuses to cut anything that is not zero.
    """
    saved = np.asarray(saved)
    shape = tuple(int(d) for d in shape)
    where = path or "<leaf>"
    if saved.dtype != np.dtype(dtype):
        raise ValueError(f"checkpoint leaf {where}: dtype {saved.dtype} != expected {np.dtype(dtype)}")
    if saved.shape == shape:
        return saved
    if saved.ndim != 1 and len(shape) != 1:
        raise ValueError(
            f"checkpoint leaf {where}: shape {saved.shape} != expected {shape} and "
            "neither is a flat ZeRO layout"
        )
    flat = saved.reshape(-1)
    target = int(np.prod(shape, dtype=np.int64))
    if flat.size > target:
        if np.count_nonzero(flat[target:]):
            raise ValueError(
                f"checkpoint leaf {where}: truncating {flat.size} -> {target} elements "
                "would drop non-zero state (not ZeRO padding): the checkpoint does not "
                "match this model/optimizer"
            )
        flat = flat[:target]
    elif flat.size < target:
        flat = np.pad(flat, (0, target - flat.size))
    return np.ascontiguousarray(flat.reshape(shape))


# ---------------------------------------------------------------------------
# Scan and validate
# ---------------------------------------------------------------------------

_torn_announced: set[str] = set()


def _announce(event: str, **fields: Any) -> None:
    print(json.dumps({"event": event, **fields}), file=sys.stderr, flush=True)


def _announce_torn(path: str, reason: str) -> None:
    if path not in _torn_announced:
        _torn_announced.add(path)
        _announce("ckpt_torn_skipped", dir=path, reason=reason)


def _load_manifest(ckpt_dir: str) -> dict | None:
    """The manifest of one step directory if it validates, else None (and
    one line on stderr): it parses, names this format, and every leaf file
    exists at its recorded size."""
    try:
        with open(os.path.join(ckpt_dir, "manifest.json")) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        _announce_torn(ckpt_dir, "no manifest (write never completed)")
        return None
    except (json.JSONDecodeError, OSError) as e:
        _announce_torn(ckpt_dir, f"unreadable manifest: {e!r}")
        return None
    if manifest.get("format") != FORMAT:
        _announce_torn(ckpt_dir, f"unknown format {manifest.get('format')!r}")
        return None
    for entry in manifest.get("leaves", []):
        try:
            size = os.path.getsize(os.path.join(ckpt_dir, entry["file"]))
        except OSError:
            _announce_torn(ckpt_dir, f"missing leaf file {entry['file']}")
            return None
        if size != entry["file_bytes"]:
            _announce_torn(
                ckpt_dir,
                f"leaf {entry['file']} is {size} bytes, manifest says {entry['file_bytes']} (truncated?)",
            )
            return None
    return manifest


def _scan_validated(directory: str) -> list[tuple[int, str, dict]]:
    """Valid ``(step, dir, manifest)`` triples, ascending by step."""
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    out = []
    for name in names:
        m = _STEP_DIR_RE.match(name)
        if not m:
            continue
        path = os.path.join(directory, name)
        manifest = _load_manifest(path)
        if manifest is not None:
            out.append((int(m.group(1)), path, manifest))
    return sorted(out, key=lambda t: t[0])


def scan_checkpoints(directory: str) -> list[tuple[int, str]]:
    """Valid ``(step, dir)`` pairs under ``directory``, ascending by step;
    torn directories are skipped."""
    return [(s, p) for s, p, _ in _scan_validated(directory)]


def latest_step(directory: str, world=None) -> int | None:
    """The latest restorable step under ``directory``, or None; in a
    ``world``, rank 0's answer on every rank."""
    ckpts = scan_checkpoints(directory)
    step = ckpts[-1][0] if ckpts else None
    if world is None:
        return step
    step = world.broadcast_int(-1 if step is None else step)
    return None if step < 0 else step


def read_manifest(directory: str, step: int | None = None) -> dict | None:
    """The validated manifest of ``step`` (default: the latest), or None."""
    for s, _, manifest in reversed(_scan_validated(directory)):
        if step is None or s == step:
            return manifest
    return None


# ---------------------------------------------------------------------------
# The write protocol
# ---------------------------------------------------------------------------


def _write_step_dir(
    directory: str,
    step: int,
    leaves: list[tuple[str, np.ndarray]],
    zero_world_size: int | None,
    metadata: Mapping[str, Any] | None,
) -> str:
    """Write one checkpoint with the crash-safe protocol; returns the
    published directory."""
    final = os.path.join(directory, f"ckpt-{step}")
    tmp = os.path.join(directory, f"{_TMP_PREFIX}{step}-{os.getpid()}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    entries = []
    for i, (path, arr) in enumerate(leaves):
        fname = f"leaf_{i:05d}.npy"
        fpath = os.path.join(tmp, fname)
        with open(fpath, "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        entries.append({
            "path": path,
            "file": fname,
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "file_bytes": os.path.getsize(fpath),
            "crc32": zlib.crc32(np.ascontiguousarray(arr).data) & 0xFFFFFFFF,
        })
    # The manifest is the commit record: written and fsync'd last, inside
    # the tmp dir, so no published dir lacks one and none with one lacks
    # its bytes.
    atomic_write_json(
        os.path.join(tmp, "manifest.json"),
        {
            "format": FORMAT,
            "version": FORMAT_VERSION,
            "step": step,
            "zero_world_size": zero_world_size,
            "metadata": dict(metadata or {}),
            "leaves": entries,
        },
        indent=1,
    )
    if os.path.exists(final):
        # A re-save of a published step: keep a valid existing dir and drop
        # ours (removing it first would open a window with neither copy on
        # disk); only a torn one is replaced.
        if _load_manifest(final) is not None:
            shutil.rmtree(tmp, ignore_errors=True)
            return final
        shutil.rmtree(final)
    os.rename(tmp, final)
    fsync_dir(directory)
    return final


def _gc(directory: str, max_to_keep: int) -> None:
    """Drop checkpoints beyond ``max_to_keep`` and stale tmp dirs (another
    process's interrupted writes; ours was just renamed)."""
    ckpts = scan_checkpoints(directory)
    for _, path in ckpts[:-max_to_keep] if max_to_keep > 0 else []:
        shutil.rmtree(path, ignore_errors=True)
    for name in os.listdir(directory):
        if name.startswith(_TMP_PREFIX):
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)


def _load_leaves(ckpt_dir: str, manifest: dict) -> dict[str, np.ndarray]:
    """The leaves of a validated checkpoint, each checked against its crc32
    (damage that left the file's size alone)."""
    out = {}
    for entry in manifest["leaves"]:
        arr = np.load(os.path.join(ckpt_dir, entry["file"]))
        if zlib.crc32(np.ascontiguousarray(arr).data) & 0xFFFFFFFF != entry["crc32"]:
            raise ValueError(f"checkpoint leaf {entry['path']} in {ckpt_dir} fails its crc32")
        out[entry["path"]] = arr
    return out


# ---------------------------------------------------------------------------
# The manager
# ---------------------------------------------------------------------------


class CheckpointManager:
    """Crash-safe, asynchronous ``TrainState`` checkpoints; see the module
    docstring.

    ``metadata`` is recorded in every manifest.  ``save()`` then ``wait()``
    is a synchronous save.  Restores check each leaf's crc32.  ``world``:
    rank 0 writes, all restore the same step (module docstring).
    """

    def __init__(
        self,
        directory: str,
        max_to_keep: int = 3,
        save_interval_steps: int = 1,
        metadata: Mapping[str, Any] | None = None,
        world=None,
    ):
        self._directory = directory
        self._max_to_keep = max_to_keep
        self._interval = max(1, int(save_interval_steps))
        self._metadata = dict(metadata or {})
        self._world = world
        self._is_writer = world is None or world.is_main
        if self._is_writer:
            os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._error: BaseException | None = None
        self._last_queued: int | None = latest_step(directory)
        self._work: queue.Queue = queue.Queue(maxsize=2)
        self._inflight = threading.Event()
        self._done = threading.Condition()
        self._thread: threading.Thread | None = None
        self._closed = False

    @property
    def directory(self) -> str:
        return self._directory

    # ---- save ------------------------------------------------------------

    def should_save(self, step: int) -> bool:
        """Would ``save(step)`` write (the interval, and not twice a step)?"""
        return step != self._last_queued and step % self._interval == 0

    def save(
        self,
        state: state_lib.TrainState,
        step: int | None = None,
        force: bool = False,
    ) -> bool:
        """Copy ``state`` to the host, here and now, and write checkpoint
        ``step`` (default ``state.step``) in the background.  Returns
        whether it saved; re-raises a failed earlier write."""
        if self._closed:
            raise RuntimeError("CheckpointManager is closed")
        step = state.step if step is None else int(step)
        if not force and not self.should_save(step):
            return False
        if not self._is_writer:
            self._last_queued = step
            return True
        self._join_inflight()  # one behind; surfaces the writer's errors
        self._raise_pending_error()
        with trace.span("ckpt_snapshot", step=step):
            leaves = state_lib.snapshot(state)
        self._last_queued = step
        self._ensure_thread()
        self._inflight.set()
        telemetry.record_ckpt_inflight(1)
        self._work.put((step, leaves))
        return True

    def _write_one(self, step: int, leaves: list[tuple[str, np.ndarray]]) -> None:
        t0 = monotonic_s()
        try:
            with trace.span("ckpt_write", step=step):
                _write_step_dir(self._directory, step, leaves, None, self._metadata)
                _gc(self._directory, self._max_to_keep)
        except BaseException as e:
            with self._lock:
                self._error = e
            # Announced now (the loop may be many steps from its next save),
            # re-raised at the next save(), wait() or close().
            _announce("ckpt_write_error", step=step, error=repr(e)[:500])
        else:
            telemetry.record_ckpt_save(
                step, monotonic_s() - t0, sum(arr.nbytes for _, arr in leaves)
            )

    def _ensure_thread(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        hb = watchdog.register("ckpt-writer")
        hb.idle()

        def run() -> None:
            try:
                while True:
                    item = self._work.get()
                    if item is None:
                        return
                    hb.beat()
                    self._write_one(*item)
                    hb.idle()
                    telemetry.record_ckpt_inflight(0)
                    with self._done:
                        self._inflight.clear()
                        self._done.notify_all()
            except BaseException as e:  # never die silently
                with self._lock:
                    if self._error is None:
                        self._error = e
                telemetry.record_ckpt_inflight(0)
                with self._done:
                    self._inflight.clear()
                    self._done.notify_all()
                _announce("ckpt_writer_crashed", error=repr(e)[:500])
                raise
            finally:
                hb.close()

        # watchdog: hb registered above (ckpt-writer); beats per write,
        # idle between saves, closed in run()'s finally.
        self._thread = threading.Thread(target=run, daemon=True, name="ckpt-writer")
        self._thread.start()

    def _join_inflight(self) -> None:
        # Checked under the condition's lock, which the writer holds to
        # clear the flag, so that no wake-up is lost.
        with self._done:
            while self._inflight.is_set():
                self._done.wait(timeout=0.5)

    def _raise_pending_error(self) -> None:
        with self._lock:
            error, self._error = self._error, None
        if error is not None:
            raise RuntimeError("checkpoint write failed (root cause chained)") from error

    def wait(self) -> None:
        """Block until the write in flight lands (in a world, on every
        rank); re-raise a failed write."""
        self._join_inflight()
        self._barrier()
        self._raise_pending_error()

    def _barrier(self) -> None:
        if self._world is not None:
            self._world.barrier()

    def close(self) -> None:
        """Finish the write in flight, stop the writer thread, and re-raise
        a failed write."""
        if self._closed:
            return
        self._join_inflight()
        if self._thread is not None and self._thread.is_alive():
            self._work.put(None)
            self._thread.join(timeout=30)
        self._closed = True
        self._barrier()
        self._raise_pending_error()

    # ---- restore ---------------------------------------------------------

    def latest_step(self) -> int | None:
        """The latest restorable step (in a world, rank 0's answer)."""
        return latest_step(self._directory, self._world)

    def _target(self, step: int | None) -> tuple[int, str, dict]:
        ckpts = _scan_validated(self._directory)
        for s, path, manifest in reversed(ckpts):
            if step is None or s == step:
                return s, path, manifest
        if step is not None:
            raise FileNotFoundError(f"no restorable checkpoint for step {step} in {self._directory}")
        raise FileNotFoundError(f"no checkpoint in {self._directory}")

    def restore(self, state: state_lib.TrainState, step: int | None = None) -> state_lib.TrainState:
        """Set ``state`` in place (model, optimizer and step, on the
        model's device) from checkpoint ``step`` (default: the latest
        valid one), and return it.

        Every leaf is checked before any is written: the checkpoint must
        hold exactly this state's leaves, parameters, statistics and step
        at their exact shape and dtype; optimizer leaves are re-laid from a
        ZeRO layout.  A mismatch raises and leaves ``state`` as it was.
        """
        if step is None and self._world is not None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self._directory}")
        _, ckpt_dir, manifest = self._target(step)
        saved = _load_leaves(ckpt_dir, manifest)
        leaves = state_lib.saveable(state)
        paths = {leaf.path for leaf in leaves}
        dropped = [p for p in saved if p.startswith(_COMM_PREFIX)]
        missing = [leaf.path for leaf in leaves if leaf.path not in saved]
        extra = [p for p in saved if p not in paths and not p.startswith(_COMM_PREFIX)]
        if missing or extra:
            raise ValueError(
                f"checkpoint {ckpt_dir} does not match this model/optimizer: missing "
                f"leaves {missing[:5]}{'...' if len(missing) > 5 else ''}, unexpected "
                f"leaves {extra[:5]}{'...' if len(extra) > 5 else ''}"
            )
        arrays = []
        for leaf in leaves:
            arr = saved[leaf.path]
            if leaf.path.startswith(_OPT_PREFIX):
                arr = reshard_flat_leaf(arr, leaf.shape, leaf.dtype, leaf.path)
            elif arr.shape != leaf.shape or arr.dtype != leaf.dtype:
                raise ValueError(
                    f"checkpoint leaf {leaf.path}: saved {arr.shape}/{arr.dtype} != expected "
                    f"{leaf.shape}/{leaf.dtype}; a different model was checkpointed here"
                )
            arrays.append(arr)
        for leaf, arr in zip(leaves, arrays):
            leaf.write(arr)
        if dropped:
            _announce(
                "ef_reset", dir=ckpt_dir, zeroed=0, dropped=len(dropped),
                reason="the checkpoint's comm_state (gradient-compression residuals) has "
                       "no counterpart in this package and was dropped",
            )
        return state

    def restore_arrays(self, step: int | None = None) -> dict[str, Any]:
        """The saved tree as nested host dicts, no template needed:
        ``params``, ``batch_stats`` and ``step`` nested, ``opt_state`` as a
        flat ``{key path: array}`` dict."""
        _, ckpt_dir, manifest = self._target(step)
        out: dict[str, Any] = {"opt_state": {}}
        key_re = re.compile(r"\['([^']*)'\]")
        for path, arr in _load_leaves(ckpt_dir, manifest).items():
            if path.startswith(_OPT_PREFIX):
                out["opt_state"][path] = arr
                continue
            if path == "['step']":
                out["step"] = arr
                continue
            keys = key_re.findall(path)
            node = out
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = arr
        out.setdefault("params", {})
        out.setdefault("batch_stats", {})
        return out
