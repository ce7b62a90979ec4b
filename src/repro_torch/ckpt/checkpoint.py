"""Crash-consistent step checkpoints (port of ``src/repro/ckpt/checkpoint.py``).

The on-disk format is the reference's format v2, byte for byte, so a
checkpoint written by either package restores in the other.

Layout:  ``<dir>/step_<N>/`` — one ``.npy`` per flattened leaf + a versioned
``manifest.json`` (format version, per-leaf name/shape/dtype/sha256/byte
size, metadata, step).  The write protocol is preemption-proof:

  1. every leaf and the manifest are written into ``step_<N>.tmp`` and
     **fsynced** (file contents reach the disk before any rename);
  2. the tmp directory is renamed over the final name in one atomic step,
     and the parent directory is fsynced so the rename itself is durable;
  3. when ``step_<N>`` already exists it is first renamed aside to
     ``step_<N>.old`` — never deleted before the new data is in place — so
     there is *no instant* at which the step has zero complete checkpoints
     (a crash between the two renames leaves the ``.old``, which the reader
     treats as that step's checkpoint).

Readers are verification-driven: ``latest_step`` walks the steps newest
first and returns the first directory that actually verifies (manifest
present and parseable, every leaf file present with the manifest's byte
size and sha256); partial ``.tmp`` garbage and bit-rotted directories are
skipped (and optionally quarantined to ``step_<N>.corrupt.*``).
``restore`` validates shape *and dtype* per leaf against both the target
structure and the manifest, with per-leaf errors.

Transient IO errors (``OSError``) during writes are retried with
exponential backoff; a checkpoint that cannot be written after the retries
raises ``CheckpointError``.  The crash-injection hooks
(``set_crash_point``, ``REPRO_CKPT_CRASH``) let tests kill the writer at
every protocol point and prove a resume always finds a valid checkpoint.

Leaf names.  A tree of dicts, NamedTuples, lists and tuples flattens to
the reference's names (JAX's ``tree_flatten_with_path``): dict keys in
sorted order as the key itself, NamedTuple fields as ``.field``, list and
tuple items as their index, joined by ``_`` (``chips_.neurons_.v``); a
``None`` is an empty subtree with no leaf; a bare leaf is ``leaf``;
duplicate names get a ``__k`` suffix.  Leaves are tensors, numpy arrays
or Python scalars, written from host numpy (``leaf.detach().cpu()``,
C order).  ``restore`` returns tensors on ``device`` (default CUDA).
Checkpoints are device-agnostic host arrays; single-writer per directory.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import re
import shutil
import time

import numpy as np
import torch

from repro_torch import resolve_device

FORMAT_VERSION = 2
MANIFEST = "manifest.json"

_STEP_RE = re.compile(r"^step_(\d{8})$")
_OLD_RE = re.compile(r"^step_(\d{8})\.old$")


class CheckpointError(RuntimeError):
    """A checkpoint could not be written, verified, or restored."""


# ---------------------------------------------------------------------------
# Crash injection (the preemption-survival harness's kill switch)
# ---------------------------------------------------------------------------

# Named protocol points where an injected "crash" (process kill) can land.
# The injection raises out of the writer with *no cleanup in between* —
# exactly the on-disk state a SIGKILL at that point leaves behind:
#   mid_leaf_write — some leaves written, no manifest, still in .tmp;
#   pre_rename     — .tmp complete (manifest + fsync) but never renamed;
#   post_rename    — checkpoint complete; the caller's follow-up (prune)
#                    never ran;
#   mid_prune      — prune removed some candidates but not all.
CRASH_POINTS = ("mid_leaf_write", "pre_rename", "post_rename", "mid_prune")

_CRASH_POINT: str | None = os.environ.get("REPRO_CKPT_CRASH") or None


class CrashInjected(RuntimeError):
    """Raised at an armed crash point (see ``set_crash_point``)."""


def set_crash_point(name: str | None) -> None:
    """Arm (or with ``None`` disarm) a crash at the named protocol point.

    The next write/prune that reaches the point raises ``CrashInjected``
    from the exact filesystem state a process kill would leave (the writer
    has no handlers between the points, so nothing is cleaned up).  Also
    settable via the ``REPRO_CKPT_CRASH`` environment variable for
    subprocess-based harnesses.
    """
    global _CRASH_POINT
    if name is not None and name not in CRASH_POINTS:
        raise ValueError(f"unknown crash point {name!r}; choose from "
                         f"{CRASH_POINTS}")
    _CRASH_POINT = name


def _maybe_crash(name: str) -> None:
    if _CRASH_POINT == name:
        set_crash_point(None)          # one-shot: the "process" died once
        raise CrashInjected(name)


# ---------------------------------------------------------------------------
# Trees: the reference's leaf names
# ---------------------------------------------------------------------------


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """(path keys, subtrees) of a container, in JAX's flattening order, or
    None for a leaf."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return [str(k) for k in keys], [tree[k] for k in keys]
    if _is_namedtuple(tree):
        return [f".{f}" for f in tree._fields], list(tree)
    if isinstance(tree, (list, tuple)):
        return [str(i) for i in range(len(tree))], list(tree)
    return None


def _flatten_paths(tree, path=()):
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(path, tree)]
    out = []
    for key, sub in zip(*kids):
        out += _flatten_paths(sub, path + (key,))
    return out


def _flatten_with_names(tree):
    """(unique leaf names, leaves) of ``tree`` in the reference's order."""
    names, leaves = [], []
    for path, leaf in _flatten_paths(tree):
        names.append(("_".join(path) or "leaf").replace("/", "_"))
        leaves.append(leaf)
    # Disambiguate duplicates deterministically.
    seen: dict[str, int] = {}
    uniq = []
    for n in names:
        k = seen.get(n, 0)
        seen[n] = k + 1
        uniq.append(f"{n}__{k}" if k else n)
    return uniq, leaves


def _unflatten(tree_like, leaves):
    """``tree_like``'s structure with its leaves taken from the iterator
    ``leaves`` in flattening order."""
    if tree_like is None:
        return None
    kids = _children(tree_like)
    if kids is None:
        return next(leaves)
    rebuilt = [_unflatten(s, leaves) for s in kids[1]]
    if isinstance(tree_like, dict):
        return dict(zip(sorted(tree_like), rebuilt))
    if _is_namedtuple(tree_like):
        return type(tree_like)(*rebuilt)
    return type(tree_like)(rebuilt)


def to_host(leaf) -> np.ndarray:
    """A leaf as the C-ordered host numpy array the writer saves."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu().numpy()
    return np.asarray(leaf, order="C")


def host_tree(tree):
    """``tree`` with every leaf copied to host numpy: a snapshot a writer
    thread can save while the tensors move on.  A card tensor's host
    copy is already its own; a CPU tensor's ``numpy()`` would share its
    memory, so that one is copied."""
    def snapshot(x):
        if isinstance(x, torch.Tensor) and x.device.type != "cpu":
            return to_host(x)
        if isinstance(x, torch.Tensor):
            x = x.detach().numpy()
        return np.array(x, order="C")         # a copy

    return _unflatten(tree, iter([snapshot(x) for _, x in
                                  _flatten_paths(tree)]))


# ---------------------------------------------------------------------------
# Internals
# ---------------------------------------------------------------------------


def _fsync_path(path: str) -> None:
    """fsync a file or directory (directories via an O_RDONLY fd)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _with_retries(fn, what: str, attempts: int, backoff_s: float):
    """Run ``fn`` retrying transient ``OSError`` with exponential backoff."""
    for k in range(attempts):
        try:
            return fn()
        except OSError as e:
            if k == attempts - 1:
                raise CheckpointError(
                    f"{what} failed after {attempts} attempts: {e}") from e
            time.sleep(backoff_s * (2 ** k))


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _candidates(directory: str) -> dict[int, str]:
    """step → path of every checkpoint candidate.  ``step_<N>`` wins;
    ``step_<N>.old`` stands in only when the final is absent (the crash
    window between an overwrite's two renames)."""
    out: dict[int, str] = {}
    fallback: dict[int, str] = {}
    for d in os.listdir(directory):
        m = _STEP_RE.match(d)
        if m:
            out[int(m.group(1))] = os.path.join(directory, d)
            continue
        m = _OLD_RE.match(d)
        if m:
            fallback[int(m.group(1))] = os.path.join(directory, d)
    for step, path in fallback.items():
        out.setdefault(step, path)
    return out


def _clean_stale_tmp(directory: str) -> None:
    """Drop ``*.tmp`` wreckage from crashed writers (single-writer dirs)."""
    for d in os.listdir(directory):
        if d.startswith("step_") and d.endswith(".tmp"):
            shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def _quarantine(path: str, problems: list[str]) -> str:
    """Move an invalid checkpoint directory aside as ``<path>.corrupt[.k]``
    (operator forensics; ``_candidates`` never lists it again) and record
    why."""
    dest = path + ".corrupt"
    k = 0
    while os.path.exists(dest):
        k += 1
        dest = f"{path}.corrupt.{k}"
    os.rename(path, dest)
    try:
        with open(os.path.join(dest, "QUARANTINE.json"), "w") as f:
            json.dump({"problems": problems}, f, indent=2)
    except OSError:
        pass                           # forensics only; never fail on it
    return dest


# ---------------------------------------------------------------------------
# Write path
# ---------------------------------------------------------------------------


def save(directory: str, step: int, tree, metadata: dict | None = None, *,
         attempts: int = 3, backoff_s: float = 0.05) -> str:
    """Atomically write a crash-consistent checkpoint for ``step``.

    Every leaf file and the manifest are fsynced inside the temp directory
    before the atomic rename, and the parent directory is fsynced after it;
    an existing ``step_<N>`` is renamed aside (never deleted) until the new
    data is in place.  Transient ``OSError`` is retried ``attempts`` times
    with exponential backoff.  Returns the final checkpoint path.
    """
    os.makedirs(directory, exist_ok=True)
    _clean_stale_tmp(directory)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp)

    names, leaves = _flatten_with_names(tree)
    manifest = {"format_version": FORMAT_VERSION, "step": step,
                "leaves": [], "metadata": metadata or {}}
    crash_at = len(names) // 2         # mid-write: some leaves, no manifest
    for i, (name, leaf) in enumerate(zip(names, leaves)):
        if i == crash_at:
            _maybe_crash("mid_leaf_write")
        arr = to_host(leaf)
        path = os.path.join(tmp, f"{name}.npy")
        _with_retries(lambda: np.save(path, arr),
                      f"write leaf {name!r}", attempts, backoff_s)
        _with_retries(lambda: _fsync_path(path),
                      f"fsync leaf {name!r}", attempts, backoff_s)
        manifest["leaves"].append({
            "name": name, "shape": list(arr.shape), "dtype": str(arr.dtype),
            "sha256": _file_sha256(path), "bytes": os.path.getsize(path)})
    mpath = os.path.join(tmp, MANIFEST)

    def _write_manifest():
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())

    _with_retries(_write_manifest, "write manifest", attempts, backoff_s)
    _with_retries(lambda: _fsync_path(tmp), "fsync checkpoint dir",
                  attempts, backoff_s)
    _maybe_crash("pre_rename")

    def _swap_in():
        if os.path.isdir(final):
            # Rename-over-previous: the old data moves aside *after* the
            # replacement is fully durable, so the step never has zero
            # complete checkpoints on disk.
            old = final + ".old"
            if os.path.exists(old):
                shutil.rmtree(old)
            os.rename(final, old)
            os.rename(tmp, final)
            _fsync_path(directory)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.rename(tmp, final)
            _fsync_path(directory)

    _with_retries(_swap_in, "rename checkpoint into place", attempts,
                  backoff_s)
    _maybe_crash("post_rename")
    return final


# ---------------------------------------------------------------------------
# Verification
# ---------------------------------------------------------------------------


def _verify_dir(path: str, *, deep: bool = True) -> list[str]:
    """Problems with one checkpoint directory (empty list = verifies).

    Checks: manifest present/parseable/versioned, every manifest leaf's
    file present with the recorded byte size and (``deep``) sha256, no
    stray ``.npy`` files the manifest doesn't know.
    """
    mpath = os.path.join(path, MANIFEST)
    if not os.path.isfile(mpath):
        return ["missing manifest.json (partial write)"]
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        return [f"unreadable manifest.json: {e}"]
    problems = []
    version = manifest.get("format_version")
    if version is None:
        problems.append("legacy manifest (no format_version, no checksums)")
    elif version > FORMAT_VERSION:
        problems.append(f"manifest format_version {version} is newer than "
                        f"this reader ({FORMAT_VERSION})")
    entries = manifest.get("leaves", [])
    for entry in entries:
        name = entry.get("name", "?")
        fpath = os.path.join(path, f"{name}.npy")
        if not os.path.isfile(fpath):
            problems.append(f"leaf {name!r}: file missing")
            continue
        size = os.path.getsize(fpath)
        if "bytes" in entry and size != entry["bytes"]:
            problems.append(f"leaf {name!r}: {size} bytes on disk, manifest "
                            f"says {entry['bytes']} (torn write)")
            continue
        if deep and "sha256" in entry:
            digest = _file_sha256(fpath)
            if digest != entry["sha256"]:
                problems.append(f"leaf {name!r}: sha256 mismatch "
                                f"({digest[:12]}… != "
                                f"{entry['sha256'][:12]}…)")
    known = {e.get("name") for e in entries}
    for f in os.listdir(path):
        if f.endswith(".npy") and f[:-4] not in known:
            problems.append(f"stray leaf file {f!r} not in manifest")
    return problems


def verify(directory: str, *, deep: bool = True) -> dict[int, list[str]]:
    """Verify every checkpoint candidate under ``directory``.

    Returns ``{step: [problems]}`` — an empty problem list means that step's
    checkpoint verifies (manifest consistent, every leaf present with the
    recorded size and checksum).  ``deep=False`` skips the sha256 pass
    (size/structure only).
    """
    if not os.path.isdir(directory):
        return {}
    return {step: _verify_dir(path, deep=deep)
            for step, path in sorted(_candidates(directory).items())}


def latest_step(directory: str, *, verified: bool = True,
                max_step: int | None = None,
                quarantine: bool = False) -> int | None:
    """Newest step whose checkpoint actually verifies.

    Walks candidates newest-first, skipping ``.tmp`` partials and any
    directory that fails verification (``verified=False`` is the name-only
    scan).  ``max_step`` bounds the search (resume "from no later than
    here"); ``quarantine`` moves failed directories aside to
    ``step_<N>.corrupt*`` so later scans don't re-hash them.
    """
    if not os.path.isdir(directory):
        return None
    cands = _candidates(directory)
    for step in sorted(cands, reverse=True):
        if max_step is not None and step > max_step:
            continue
        if not verified:
            return step
        problems = _verify_dir(cands[step])
        if not problems:
            return step
        if quarantine:
            _quarantine(cands[step], problems)
    return None


# ---------------------------------------------------------------------------
# Read path
# ---------------------------------------------------------------------------


def read_manifest(directory: str, step: int) -> dict:
    """The manifest of ``step``'s checkpoint (no leaf data read)."""
    cands = _candidates(directory)
    if step not in cands:
        raise FileNotFoundError(f"no checkpoint for step {step} under "
                                f"{directory}")
    with open(os.path.join(cands[step], MANIFEST)) as f:
        return json.load(f)


def _like_dtype(like) -> np.dtype:
    if isinstance(like, torch.Tensor):
        return torch.empty(0, dtype=like.dtype).numpy().dtype
    if hasattr(like, "dtype"):
        return np.dtype(str(like.dtype))
    return np.asarray(like).dtype


def restore(directory: str, tree_like, step: int | None = None, *,
            device=None, check_integrity: bool = True,
            quarantine: bool = False):
    """Load a checkpoint into the structure of ``tree_like``.

    Every leaf is validated against *both* the target structure and the
    manifest — shape and dtype each — and (``check_integrity``) its file
    bytes are checksummed against the manifest's sha256 before being
    trusted; all per-leaf failures are reported together in one
    ``CheckpointError``.  With ``step=None`` the newest *verified*
    checkpoint is used (invalid ones skipped, and quarantined when
    ``quarantine``).  Leaves come back as tensors on ``device`` (default
    CUDA; raises without one).

    Returns ``(tree, manifest)``.
    """
    device = resolve_device(device)
    if step is None:
        step = latest_step(directory, verified=True, quarantine=quarantine)
        if step is None:
            raise FileNotFoundError(f"no valid checkpoints under {directory}")
    cands = _candidates(directory)
    if step not in cands:
        raise FileNotFoundError(f"no checkpoint for step {step} under "
                                f"{directory}")
    path = cands[step]
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    by_name = {e["name"]: e for e in manifest.get("leaves", [])}

    names, leaves_like = _flatten_with_names(tree_like)
    missing = [n for n in names if n not in by_name]
    extra = sorted(set(by_name) - set(names))
    if missing or extra:
        raise CheckpointError(
            f"checkpoint step {step} does not match the target structure: "
            f"missing leaves {missing or 'none'}, unexpected leaves "
            f"{extra or 'none'}")

    loaded, errors = [], []
    for name, like in zip(names, leaves_like):
        entry = by_name[name]
        fpath = os.path.join(path, f"{name}.npy")
        try:
            with open(fpath, "rb") as f:
                data = f.read()
        except OSError as e:
            errors.append(f"leaf {name!r}: unreadable ({e})")
            continue
        if check_integrity and "sha256" in entry:
            if hashlib.sha256(data).hexdigest() != entry["sha256"]:
                errors.append(f"leaf {name!r}: checksum mismatch (bit rot "
                              f"or torn write)")
                continue
        try:
            arr = np.load(io.BytesIO(data))
        except ValueError as e:
            errors.append(f"leaf {name!r}: undecodable npy ({e})")
            continue
        if (list(arr.shape) != list(entry["shape"])
                or str(arr.dtype) != entry["dtype"]):
            errors.append(
                f"leaf {name!r}: file is {arr.dtype}{tuple(arr.shape)} but "
                f"the manifest recorded {entry['dtype']}"
                f"{tuple(entry['shape'])}")
        like_shape = tuple(np.shape(like))
        like_dtype = _like_dtype(like)
        if tuple(arr.shape) != like_shape:
            errors.append(f"leaf {name!r}: shape mismatch on restore: "
                          f"checkpoint {tuple(arr.shape)} vs target "
                          f"{like_shape}")
        if arr.dtype != like_dtype:
            errors.append(f"leaf {name!r}: dtype mismatch on restore: "
                          f"checkpoint {arr.dtype} vs target slot "
                          f"{like_dtype}")
        loaded.append(arr)
    if errors:
        raise CheckpointError(
            f"restore of step {step} failed:\n  " + "\n  ".join(errors))

    tensors = [torch.from_numpy(a).to(device) for a in loaded]
    return _unflatten(tree_like, iter(tensors)), manifest


# ---------------------------------------------------------------------------
# Retention
# ---------------------------------------------------------------------------


def prune(directory: str, keep: int = 3, *, deep: bool = False) -> list[int]:
    """Keep only the newest ``keep`` *verified* checkpoints.

    ``keep`` is clamped to ≥ 1 and only verified checkpoints count toward
    it, so prune can never remove the only checkpoint that actually
    restores: unverifiable directories are removed regardless (they are
    write wreckage, not retention candidates), verified ones only beyond
    the newest ``keep``.  The retention scan is shallow by default
    (manifest + byte sizes; ``deep=True`` adds the sha256 pass, and the
    *read* path always checksums).  Stale ``.tmp`` partials are cleared
    too; quarantined ``.corrupt`` directories are left for the operator.
    Returns the removed steps.
    """
    if not os.path.isdir(directory):
        return []
    keep = max(1, int(keep))
    cands = _candidates(directory)
    verified_steps = [s for s in sorted(cands, reverse=True)
                      if not _verify_dir(cands[s], deep=deep)]
    keep_set = set(verified_steps[:keep])
    removed = []
    for s in sorted(cands):
        if s in keep_set:
            continue
        shutil.rmtree(cands[s], ignore_errors=True)
        removed.append(s)
        _maybe_crash("mid_prune")
    _clean_stale_tmp(directory)
    return removed
