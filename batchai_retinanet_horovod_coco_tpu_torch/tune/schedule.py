"""Per-device schedule registry: schema-validated JSON, loud fallback.

The port's copy of the JAX package's ``tune/schedule.py``, with the same
contract:

- one file a device kind, ``<slug>.json`` under ``tune/schedules/`` in this
  package, or under the directory that ``RETINANET_TORCH_SCHEDULE_DIR``
  names (the JAX package's ``artifacts/schedules/`` and its variable are
  never read);
- **schema-validated at load** (:func:`validate_schedule`): every problem
  is named, a malformed file never silently changes a consumer;
- **a device with no file, or an invalid one, falls back to the built-in
  defaults** with ONE structured ``schedule_fallback`` JSON line on stderr
  per (device kind, reason) per process, never a crash;
- a file may name only some entries: it deep-merges over the defaults;
- lookups are cached by the resolved path, and :func:`save_schedule` is
  atomic.

The device kind is the consumer's torch device (each function's
``device_kind`` takes a ``torch.device`` or a kind): the card's
``torch.cuda.get_device_name`` (for example ``NVIDIA H100 80GB HBM3``, slug
``nvidia_h100_80gb_hbm3``) or ``cpu``; a lookup for the CPU never
initialises CUDA.  The entries and their units:

- ``nms.pre_nms_size``: candidates an image that reach the suppression (1
  to the NMS kernel's largest K, 8192), read by the detect path
  (``evaluate/detect.py``);
- the kernels' launch shapes, each read by its kernel's consumer, with
  its unit, menu and default in ``ops/cuda/shapes.py``: ``nms.mask_lanes``
  (threads sharing one row of the mask pass's 64 x 64 block) and
  ``nms.scan_threads`` (threads of the scan's block), read by the detect
  path; ``focal.fwd_tile_a`` (groups a forward block) and
  ``focal.bwd_tile_a`` (threads a backward block) and ``matching.tile_a``
  (anchors a block), read by the train step (``train/step.py``).

Each launch key takes only a value of its kernel's menu (:data:`MENUS`),
and the defaults are the kernels' launch shapes before the menus existed,
so a device with no file launches exactly those.  Refused, each with its
reason: ``impl`` (the port never takes a plain version on a card),
``block_k`` (the NMS scan's word is 64 candidates because its bitsets are
uint64, not a launch choice), ``eval`` (its reader, the benchmark
harness's eval, is not ported) and ``serve`` (per-bucket batch sizes: no
entry point of the port builds the serve engine from a live model, and a
batch size is chosen by timing the whole detect program, which the search
does not).

Import-light (the standard library, and torch only where a CUDA device is
named), so the shm decode workers can import a consumer of it.
"""

from __future__ import annotations

import copy
import json
import os
import re
import sys
from typing import Any

from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda.shapes import DEFAULTS as SHAPE_DEFAULTS
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda.shapes import MENUS

FORMAT = "retinanet_torch.schedule.v1"
ENV_DIR = "RETINANET_TORCH_SCHEDULE_DIR"
# ops/cuda/nms.cu's kMaxK: the most candidates one image's keep mask takes.
NMS_MAX_K = 8192

# The built-in entries: pre_nms_size, and each kernel's default launch shape.
DEFAULT_SCHEDULE: dict[str, Any] = {"nms": {"pre_nms_size": 1000}, "focal": {}, "matching": {}}
for (_op, _key), _shape in SHAPE_DEFAULTS.items():
    DEFAULT_SCHEDULE[_op][_key] = _shape

# Keys and entries of the JAX registry that the port refuses, with the reason.
_REFUSED = {
    "impl": "the port never takes a plain version on a card",
    "block_k": "the NMS word is 64 candidates because the scan's bitsets are uint64; "
               "its launch shapes are mask_lanes and scan_threads",
}
_REFUSED_OPS = {
    "eval": "its reader, the benchmark harness's eval, is not ported",
    "serve": "no entry point of the port builds the serve engine from a live model, and the "
             "search does not time the whole detect program",
}


class ScheduleError(ValueError):
    """A schedule file violates the schema (every problem listed)."""


def validate_schedule(doc: Any) -> dict:
    """Validate a schedule document; returns it, or raises ScheduleError
    naming every problem."""
    problems: list[str] = []
    if not isinstance(doc, dict):
        raise ScheduleError(f"schedule must be a JSON object, got {type(doc).__name__}")
    if doc.get("format") != FORMAT:
        problems.append(f"format: expected {FORMAT!r}, got {doc.get('format')!r}")
    kind = doc.get("device_kind")
    if not isinstance(kind, str) or not kind:
        problems.append(f"device_kind: non-empty string required, got {kind!r}")
    entries = doc.get("entries")
    if not isinstance(entries, dict):
        problems.append(f"entries: object required, got {type(entries).__name__}")
        entries = {}
    unknown = sorted(set(entries) - set(DEFAULT_SCHEDULE))
    if unknown:
        why = "".join(f"; {op}: {_REFUSED_OPS[op]}" for op in unknown if op in _REFUSED_OPS)
        problems.append(f"entries: unknown op keys {unknown} (known: "
                        f"{sorted(DEFAULT_SCHEDULE)}){why}")
    for op in ("nms", "focal", "matching"):
        e = entries.get(op)
        if e is None:
            continue
        if not isinstance(e, dict):
            problems.append(f"{op}: object required")
            continue
        bad = sorted(set(e) - set(DEFAULT_SCHEDULE[op]))
        if bad:
            why = "".join(f"; {k}: {_REFUSED[k]}" for k in bad if k in _REFUSED)
            problems.append(f"{op}: unknown keys {bad}{why}")
        for key in sorted(set(e) & set(DEFAULT_SCHEDULE[op])):
            v = e[key]
            menu = MENUS.get((op, key))
            if menu is not None and (not isinstance(v, int) or isinstance(v, bool) or v not in menu):
                problems.append(f"{op}.{key}: one of the kernel's menu {list(menu)} required, "
                                f"got {v!r}")
        if "pre_nms_size" in e:
            v = e["pre_nms_size"]
            if not isinstance(v, int) or isinstance(v, bool) or not 1 <= v <= NMS_MAX_K:
                problems.append(f"nms.pre_nms_size: int in [1, {NMS_MAX_K}] required (the NMS "
                                f"kernel's largest K), got {v!r}")
    if "trials" in doc and not isinstance(doc["trials"], list):
        problems.append("trials: list required when present")
    if problems:
        raise ScheduleError("invalid schedule artifact:\n  - " + "\n  - ".join(problems))
    return doc


def device_slug(device_kind: str) -> str:
    """'NVIDIA H100 80GB HBM3' -> 'nvidia_h100_80gb_hbm3' (the file's stem)."""
    return re.sub(r"[^a-z0-9]+", "_", device_kind.lower()).strip("_") or "unknown"


def resolve_kind(device_kind: Any = None) -> str:
    """The kind of a torch device (a ``torch.device``, or a string torch
    parses as one): the card's name, or ``cpu``.  Any other string is a
    device kind already.  None is the current card where this process has
    initialised CUDA, else ``unknown``: a lookup never initialises it."""
    device = device_kind
    if device is None:
        torch = sys.modules.get("torch")
        if torch is not None and torch.cuda.is_initialized():
            return torch.cuda.get_device_name(torch.cuda.current_device())
        return "unknown"
    text = str(device)
    if text == "cpu" or text.startswith("cpu:"):
        return "cpu"
    if text != "cuda" and not text.startswith("cuda:"):
        return text
    import torch

    return torch.cuda.get_device_name(torch.device(text))


def schedule_dir(root: str | None = None) -> str:
    """``tune/schedules/`` in this package, or ``root``; the environment
    variable ``RETINANET_TORCH_SCHEDULE_DIR`` overrides the default."""
    if root is not None:
        return root
    return os.environ.get(ENV_DIR) or os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                   "schedules")


def schedule_path(kind: str, root: str | None = None) -> str:
    return os.path.join(schedule_dir(root), f"{device_slug(kind)}.json")


def save_schedule(doc: dict, root: str | None = None) -> str:
    """Validate and write one device's schedule, atomically; returns its
    path."""
    from batchai_retinanet_horovod_coco_tpu_torch.utils.atomicio import atomic_write_text

    validate_schedule(doc)
    path = schedule_path(doc["device_kind"], root)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    atomic_write_text(path, json.dumps(doc, indent=2, sort_keys=True) + "\n")
    _cache.clear()
    return path


def load_schedule(path: str) -> dict:
    """Read and validate one file; raises on any violation."""
    with open(path) as f:
        return validate_schedule(json.load(f))


def _merged(entries: dict) -> dict:
    out = copy.deepcopy(DEFAULT_SCHEDULE)
    for op, e in entries.items():
        out[op].update(e)
    return out


# One event per (device kind, reason) per process: the consumers resolve the
# schedule once per bucket build, and a thousand identical lines would bury
# the one that matters.
_warned: set[tuple[str, str]] = set()
_cache: dict[str, dict] = {}


def _emit_fallback(kind: str, reason: str, detail: str) -> None:
    if (kind, reason) in _warned:
        return
    _warned.add((kind, reason))
    print(json.dumps({"event": "schedule_fallback", "device_kind": kind, "reason": reason,
                      "detail": detail[:500], "using": "built-in defaults"}),
          file=sys.stderr, flush=True)


def lookup(device_kind: Any = None, root: str | None = None) -> dict[str, Any]:
    """The consumers' entry point: the defaults deep-merged with the
    device's file where one exists and validates, else the defaults and one
    ``schedule_fallback`` line (reason ``no_schedule_artifact`` or
    ``invalid_schedule_artifact``; :func:`load_schedule` is the strict
    read).  Cached by the resolved path, which folds in ``root`` and the
    environment override."""
    kind = resolve_kind(device_kind)
    path = schedule_path(kind, root)
    hit = _cache.get(path)
    if hit is not None:
        return copy.deepcopy(hit)
    if not os.path.exists(path):
        _emit_fallback(kind, "no_schedule_artifact", path)
        merged = _merged({})
    else:
        try:
            merged = _merged(load_schedule(path)["entries"])
        except (ScheduleError, OSError, ValueError) as e:
            _emit_fallback(kind, "invalid_schedule_artifact", f"{path}: {e}")
            merged = _merged({})
    _cache[path] = merged
    return copy.deepcopy(merged)


def provenance(device_kind: Any = None, root: str | None = None) -> dict[str, Any]:
    """Where the device's schedule came from (the export manifest's record):
    ``{"device_kind", "source" (a path, relative to the checkout when it
    lies inside it, or "defaults"), "found"}``."""
    kind = resolve_kind(device_kind)
    path = schedule_path(kind, root)
    found = False
    if os.path.exists(path):
        try:
            load_schedule(path)
            found = True
        except (ScheduleError, OSError, ValueError):
            found = False
    checkout = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if found and os.path.abspath(path).startswith(checkout + os.sep):
        path = os.path.relpath(path, checkout)
    return {"device_kind": kind, "source": path if found else "defaults", "found": found}
