"""Durable manifest-committed checkpoints of the port, in the reference
package's on-disk format (``checkpoint/ckpt.py``), unchanged.

Layout of a checkpoint directory::

    ck/
      state-<sha256[:16]>.npz      # content-addressed state (params/opt/extra)
      manifest-00000007.json       # ONE commit = ONE atomic manifest rename
      manifest-00000008.json       # newest manifest wins; older = fallbacks

A snapshot is committed by exactly ONE ``os.replace`` — of the manifest.
State bytes are written first under a content-hash name (a crash before the
manifest rename leaves an unreferenced blob, never a torn snapshot); the
manifest records the state file and its full sha256, so :func:`load`
validates the bytes it reads and *falls back to the previous manifest* on a
torn / truncated / corrupted snapshot.  Unrecoverable corruption raises
:class:`CheckpointCorruptError` naming the offending file.  Keep-last-k
retention garbage-collects old manifests and any state blobs no retained
manifest references.  The npz members are ``params.<dotted path>``,
``opt.<key>`` and ``extra.<key>``, as the reference writes them, so each
package reads the other's checkpoints.

``meta`` is free-form JSON.  ``PrivacySession.checkpoint`` stores the
privacy accountant's full state under ``meta["accountant"]`` and the
state's two noise-key words under ``extra["rng"]``; with the counter-based
sampler that makes kill-anywhere + resume bitwise identical to the
uninterrupted run.

:class:`AsyncCheckpointer` moves the device→host copy and the file writes
off the step path.  The port updates params and optimizer state IN PLACE,
so ``save`` takes its copy before it returns: on a card it enqueues the
copies into pinned host buffers on a side stream (after the work already
enqueued on the current stream) and records an event; :meth:`fence` makes
the current stream wait for that event, and the session calls it before
the next update touches the state.  No kernel runs on the side stream, only
copies.  A background thread waits for the copy and runs the commit.
Transient I/O failures are retried with exponential backoff (injectable
``sleep`` for tests); retry/failure counts and the copy and commit times
flow through the obs registry.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import threading
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..obs import as_registry
from ..resilience.faults import fault_point
from ..utils.params import flatten_params

MANIFEST_VERSION = 1
_MANIFEST_RE = re.compile(r"^manifest-(\d{8})\.json$")


class CheckpointCorruptError(RuntimeError):
    """A snapshot failed validation (torn write, truncated file, digest
    mismatch, missing member).  ``offending`` names the bad file;
    ``fallback`` is the last good manifest (None when nothing in the
    directory is restorable)."""

    def __init__(self, message: str, *, path: str = "",
                 offending: Optional[str] = None,
                 fallback: Optional[str] = None):
        super().__init__(message)
        self.path = path
        self.offending = offending
        self.fallback = fallback


@dataclasses.dataclass
class Snapshot:
    """A validated restored checkpoint; ``params`` is flat,
    ``{dotted path: array}``."""
    params: dict
    opt_flat: Dict[str, np.ndarray]
    step: int
    meta: dict
    extra: Dict[str, np.ndarray]
    manifest: Optional[str] = None      # manifest file name (None = legacy)


def _flatten_state(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten_state(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            out.update(_flatten_state(v, f"{prefix}{i}."))
        return out
    out[prefix[:-1]] = tree
    return out


def unflatten_state(flat: Dict[str, np.ndarray], template: Any,
                    _prefix: str = "") -> Any:
    """Rebuild a ``_flatten_state``-style flat dict into the structure of
    ``template``, casting each leaf to the template's dtype/shape.  ``None``
    leaves in the template stay None (they were never saved); a template
    leaf with no saved entry raises ``KeyError`` naming the path."""
    if isinstance(template, dict):
        return {k: unflatten_state(flat, v, f"{_prefix}{k}.")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)) and not hasattr(template, "_fields"):
        vals = [unflatten_state(flat, v, f"{_prefix}{i}.")
                for i, v in enumerate(template)]
        return type(template)(vals)
    if template is None:
        return None
    key = _prefix[:-1]
    if key not in flat:
        raise KeyError(f"checkpoint has no entry for state leaf {key!r}")
    t = np.asarray(template)
    return np.asarray(flat[key]).astype(t.dtype).reshape(t.shape)


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return                      # platform without dir-fd semantics
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _list_manifests(path: str) -> List[Tuple[int, str]]:
    """(seq, filename) pairs, ascending seq."""
    out = []
    try:
        names = os.listdir(path)
    except FileNotFoundError:
        return []
    for name in names:
        m = _MANIFEST_RE.match(name)
        if m:
            out.append((int(m.group(1)), name))
    return sorted(out)


def save(path: str, params: Any, opt_state: Any = None, step: int = 0,
         meta: Optional[dict] = None, *, extra: Optional[dict] = None,
         keep: Optional[int] = None) -> str:
    """Write one snapshot; returns the committed manifest's file name.

    The commit point is the single atomic rename of the manifest — a crash
    at ANY earlier instant leaves the directory exactly as restorable as it
    was before the call (at worst plus an unreferenced, GC-able state blob).

    ``extra`` is a flat name->array dict stored beside params/opt (the
    session puts the train-state RNG key here).  ``keep`` retains the last
    k manifests and garbage-collects everything older (None = keep all).
    """
    os.makedirs(path, exist_ok=True)
    fault_point("ckpt/before_state")
    fault_point("ckpt/io_write")
    flat = {f"params.{k}": np.asarray(v)
            for k, v in flatten_params(params).items()}
    if opt_state is not None:
        flat.update({f"opt.{k}": np.asarray(v)
                     for k, v in _flatten_state(opt_state).items()
                     if v is not None})
    for k, v in (extra or {}).items():
        flat[f"extra.{k}"] = np.asarray(v)
    tmp = os.path.join(
        path, f".tmp-state-{os.getpid()}-{threading.get_ident()}.npz")
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    digest = _sha256_file(tmp)
    state_name = f"state-{digest[:16]}.npz"
    os.replace(tmp, os.path.join(path, state_name))
    fault_point("ckpt/after_state_before_manifest")

    manifests = _list_manifests(path)
    seq = (manifests[-1][0] + 1) if manifests else 1
    manifest_name = f"manifest-{seq:08d}.json"
    record = {"version": MANIFEST_VERSION, "step": int(step),
              "state": state_name, "sha256": digest, "meta": meta or {}}
    mtmp = os.path.join(
        path, f".tmp-manifest-{os.getpid()}-{threading.get_ident()}.json")
    with open(mtmp, "w") as f:
        json.dump(record, f)
        f.flush()
        os.fsync(f.fileno())
    # THE commit point: one atomic rename makes the snapshot visible
    os.replace(mtmp, os.path.join(path, manifest_name))
    _fsync_dir(path)
    fault_point("ckpt/after_manifest_before_gc")
    if keep is not None:
        gc(path, keep)
    return manifest_name


def gc(path: str, keep: int) -> List[str]:
    """Drop all but the newest ``keep`` manifests, then delete state blobs
    no retained manifest references (plus stale .tmp files).  Returns the
    deleted file names.  Never touches the newest manifest."""
    if keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    manifests = _list_manifests(path)
    drop, hold = manifests[:-keep], manifests[-keep:]
    deleted = []
    referenced = set()
    for _seq, name in hold:
        try:
            with open(os.path.join(path, name)) as f:
                referenced.add(json.load(f).get("state"))
        except (OSError, json.JSONDecodeError):
            pass                    # corrupt retained manifest: keep blobs
    for _seq, name in drop:
        try:
            os.remove(os.path.join(path, name))
            deleted.append(name)
        except OSError:
            pass
    for name in os.listdir(path):
        stale_tmp = name.startswith(".tmp-")
        blob = name.startswith("state-") and name.endswith(".npz")
        if stale_tmp or (blob and name not in referenced):
            try:
                os.remove(os.path.join(path, name))
                deleted.append(name)
            except OSError:
                pass
    return deleted


def _load_manifest(path: str, manifest_name: str) -> Snapshot:
    """Validate + load one manifest's snapshot; CheckpointCorruptError on
    any torn/truncated/garbage file."""
    mpath = os.path.join(path, manifest_name)

    def corrupt(msg, offending):
        return CheckpointCorruptError(
            f"{os.path.join(path, offending)}: {msg}",
            path=path, offending=offending)

    try:
        with open(mpath) as f:
            record = json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
        raise corrupt(f"unreadable manifest ({e})", manifest_name) from e
    if not isinstance(record, dict) or "state" not in record \
            or "sha256" not in record:
        raise corrupt("manifest missing state/sha256 fields", manifest_name)
    state_name = record["state"]
    spath = os.path.join(path, state_name)
    if not os.path.exists(spath):
        raise corrupt(f"state file {state_name} referenced by "
                      f"{manifest_name} is missing", state_name)
    digest = _sha256_file(spath)
    if digest != record["sha256"]:
        raise corrupt(
            f"digest mismatch (manifest {manifest_name} expects "
            f"{record['sha256'][:16]}..., file hashes to {digest[:16]}...): "
            f"torn or corrupted write", state_name)
    try:
        with np.load(spath) as z:
            arrays = {k: z[k] for k in z.files}     # force-read every member
    except Exception as e:      # zipfile/np errors vary; digest already ok,
        raise corrupt(f"unreadable npz ({e})", state_name) from e
    pflat = {k[len("params."):]: v for k, v in arrays.items()
             if k.startswith("params.")}
    if not pflat:
        raise corrupt("no params.* members in state file", state_name)
    oflat = {k[len("opt."):]: v for k, v in arrays.items()
             if k.startswith("opt.")}
    extra = {k[len("extra."):]: v for k, v in arrays.items()
             if k.startswith("extra.")}
    meta = record.get("meta") or {}
    return Snapshot(params=pflat, opt_flat=oflat,
                    step=int(record.get("step", 0)), meta=meta, extra=extra,
                    manifest=manifest_name)


def _load_legacy(path: str) -> Snapshot:
    """Pre-manifest layout (state.npz + meta.json double os.replace) —
    read-only compatibility; new saves always commit a manifest."""
    spath = os.path.join(path, "state.npz")
    try:
        with np.load(spath) as z:
            arrays = {k: z[k] for k in z.files}
    except Exception as e:
        raise CheckpointCorruptError(
            f"{spath}: unreadable legacy state ({e})", path=path,
            offending="state.npz") from e
    pflat = {k[len("params."):]: v for k, v in arrays.items()
             if k.startswith("params.")}
    oflat = {k[len("opt."):]: v for k, v in arrays.items()
             if k.startswith("opt.")}
    meta = {}
    mpath = os.path.join(path, "meta.json")
    if os.path.exists(mpath):
        with open(mpath) as f:
            meta = json.load(f)
    return Snapshot(params=pflat, opt_flat=oflat,
                    step=int(meta.get("step", 0)), meta=meta, extra={},
                    manifest=None)


def load(path: str) -> Snapshot:
    """Restore the newest VALID snapshot, falling back manifest by manifest
    past torn/corrupt ones (with a warning naming what was skipped).
    Raises :class:`CheckpointCorruptError` when manifests exist but none
    validates, ``FileNotFoundError`` when the directory holds no checkpoint
    at all."""
    manifests = _list_manifests(path)
    if not manifests:
        if os.path.exists(os.path.join(path, "state.npz")):
            return _load_legacy(path)
        raise FileNotFoundError(f"no checkpoint at {path!r} "
                                f"(no manifest-*.json, no legacy state.npz)")
    errors: List[CheckpointCorruptError] = []
    for _seq, name in reversed(manifests):
        try:
            snap = _load_manifest(path, name)
        except CheckpointCorruptError as e:
            errors.append(e)
            continue
        if errors:
            skipped = ", ".join(e.offending or "?" for e in errors)
            warnings.warn(
                f"checkpoint at {path!r}: skipped corrupt snapshot(s) "
                f"[{skipped}], restored last good manifest {name}",
                RuntimeWarning, stacklevel=2)
        return snap
    first = errors[0]
    raise CheckpointCorruptError(
        f"no restorable checkpoint at {path!r}: {first} "
        f"(last good manifest: none; {len(errors)} manifest(s) failed "
        f"validation)", path=path, offending=first.offending, fallback=None)


def restore(path: str) -> Tuple[dict, dict, int, dict]:
    """Returns (params, flat_opt_state, step, meta) — see :func:`load` for
    the full snapshot (extra arrays, manifest name)."""
    snap = load(path)
    return snap.params, snap.opt_flat, snap.step, snap.meta


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


class AsyncCheckpointer:
    """Background checkpoint writer (see module docstring).

    One write may be in flight at a time; a second ``save`` first waits for
    it (bounding dirty state to one checkpoint interval).  ``wait`` makes
    the last enqueued checkpoint durable — call it before reading the files
    back or at the end of training.  Exceptions raised by the background
    write re-surface on the next ``save``/``wait``.

    ``OSError``\\ s from the write are retried up to ``retries`` times with
    exponential backoff (``backoff * 2**attempt`` seconds, via the
    injectable ``sleep``); only a write that exhausts its retries surfaces.
    ``ckpt/saves`` / ``ckpt/retries`` / ``ckpt/failures`` counters and the
    ``ckpt/d2h`` / ``ckpt/commit`` times (seconds) are emitted through
    ``obs``; ``records`` keeps one dict per committed save (step, bytes,
    d2h_ms, commit_s).
    """

    def __init__(self, *, retries: int = 2, backoff: float = 0.05,
                 sleep: Callable[[float], None] = time.sleep,
                 keep: Optional[int] = 3, obs=None):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.retries = int(retries)
        self.backoff = float(backoff)
        self.keep = keep
        self._sleep = sleep
        self._obs = as_registry(obs)
        self._host: Dict[tuple, torch.Tensor] = {}   # reused pinned buffers
        self._stream = None                          # the copy stream
        self._copied = None                          # its event, unfenced
        self.records: List[dict] = []

    def _buffers(self, tree, tag: str):
        """A host buffer per tensor of ``tree`` (pinned for CUDA tensors),
        kept and reused by the next save; other leaves become numpy."""
        counter = iter(range(1 << 30))

        def buffer(x):
            if not isinstance(x, torch.Tensor):
                return np.asarray(x)
            key = (tag, next(counter), tuple(x.shape), x.dtype)
            buf = self._host.get(key)
            if buf is None:
                buf = self._host[key] = torch.empty(
                    x.shape, dtype=x.dtype, pin_memory=x.is_cuda)
            return buf
        return _map(buffer, tree)

    def _copy(self, bufs, tree) -> None:
        """Enqueue the copies of ``tree``'s tensors into ``bufs`` (on the
        current stream: the side stream for CUDA tensors)."""
        if isinstance(tree, dict):
            for k, v in tree.items():
                self._copy(bufs[k], v)
        elif isinstance(tree, torch.Tensor):
            x = tree.detach()
            if x.is_cuda:
                x.record_stream(self._stream)    # read on the side stream
            bufs.copy_(x, non_blocking=x.is_cuda)

    def fence(self) -> None:
        """Make the current CUDA stream wait until the last save's copies
        have read the state (call before anything rewrites it in place)."""
        if self._copied is not None:
            torch.cuda.current_stream(self._copied[1].device).wait_event(
                self._copied[1])
            self._copied = None

    def save(self, path: str, params: Any, opt_state: Any = None,
             step: int = 0, meta: Optional[dict] = None,
             extra: Optional[dict] = None) -> None:
        """Enqueue a checkpoint write; blocks only on a still-running
        previous write.  ``step``/``meta`` must be host values; the tensors
        of ``params``/``opt_state``/``extra`` are copied before the next
        :meth:`fence` returns."""
        self.wait()
        trees = {"params": params, "opt": opt_state, "extra": extra}
        cuda = [t for tree in trees.values() if tree is not None
                for t in _leaves(tree)
                if isinstance(t, torch.Tensor) and t.is_cuda]
        events = None
        host = {k: None if v is None else self._buffers(v, k)
                for k, v in trees.items()}
        if cuda:
            dev = cuda[0].device
            if self._stream is None:
                self._stream = torch.cuda.Stream(dev)
            self._stream.wait_stream(torch.cuda.current_stream(dev))
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            with torch.cuda.stream(self._stream):
                events[0].record()
                for k, v in trees.items():
                    if v is not None:
                        self._copy(host[k], v)
                events[1].record()
            self._copied = (dev, events[1])
        else:
            t0 = time.perf_counter()
            for k, v in trees.items():
                if v is not None:
                    self._copy(host[k], v)
            d2h_ms = 1e3 * (time.perf_counter() - t0)

        def _write():
            try:
                fault_point("ckpt/mid_d2h")
                ms = d2h_ms if events is None else None
                if events is not None:
                    events[1].synchronize()
                    ms = events[0].elapsed_time(events[1])
                arrays = _map(lambda x: x.numpy()
                              if isinstance(x, torch.Tensor) else x, host)
                nbytes = sum(a.nbytes for tree in arrays.values()
                             if tree is not None for a in _leaves(tree))
                self._obs.observe("ckpt/d2h", float(ms) / 1e3)
                for attempt in range(self.retries + 1):
                    try:
                        t0 = time.perf_counter()
                        save(path, arrays["params"], arrays["opt"], step,
                             meta, extra=arrays["extra"], keep=self.keep)
                        commit_s = time.perf_counter() - t0
                        self._obs.observe("ckpt/commit", float(commit_s))
                        self._obs.inc("ckpt/saves")
                        self.records.append({
                            "step": int(step), "bytes": int(nbytes),
                            "d2h_ms": float(ms), "commit_s": commit_s})
                        return
                    except OSError as e:
                        if attempt == self.retries:
                            raise e
                        self._obs.inc("ckpt/retries")
                        self._sleep(self.backoff * (2 ** attempt))
            except BaseException as e:     # surfaced by the next save/wait
                self._obs.inc("ckpt/failures")
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True,
                                        name="repro-torch-async-ckpt")
        self._thread.start()

    @property
    def in_flight(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def wait(self) -> None:
        """Block until the pending write (if any) is durable; re-raise any
        background failure."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
