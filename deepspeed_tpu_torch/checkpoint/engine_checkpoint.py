"""Engine checkpoint save/load in the JAX package's on-disk format (port of
``deepspeed_tpu/checkpoint/engine_checkpoint.py``).

A tag written by the JAX engine resumes here, and one written here resumes
in the JAX engine, on the same trajectory. Layout (the JAX package's):

    <save_dir>/
      latest                      # text file holding the newest tag
      <tag>/
        state.npz                 # leaf_00000 ... in the JAX tree's order
        meta.json                 # versions, counters, paths, shapes,
                                  # dtypes, checksums, client state

The JAX engine saves its ``TrainState`` pytree, flattened by
``jax.tree_util``. :func:`state_leaves` is the map from the port's
``TrainState`` to that leaf list, and :func:`load_checkpoint` the map
back:

- the order: ``step``, ``params/...``, ``opt_state/...``,
  ``scale_state/{scale,growth_tracker,hysteresis,overflows}``, ``rng``;
  inside a dict every level's keys sorted as strings (``layer_10`` before
  ``layer_2``), where the engine keeps the tree's insertion order;
- the optimizer's structure, the optax chain the JAX package builds:
  AdamW (and Adam with ``adam_w_mode``) ``opt_state/0/{count,mu,nu}`` and
  the schedule's ``opt_state/2/count``; Adam with L2 decay
  ``opt_state/1/0/...`` and ``opt_state/1/1/count`` (``opt_state/0`` and
  ``opt_state/1`` without decay); the compact AdamW ``opt_state/{count,
  mu,nu}``. Both optax counts are the port's one ``AdamState.count``;
- the dtypes: ``step``, the counts and the loss-scale integers int32,
  ``scale`` float32, ``rng`` uint32 ``[2]`` (the port holds int64 words);
- bf16 leaves (compact-AdamW moments, bf16 master params) as numpy writes
  an ``ml_dtypes`` bfloat16 array: raw 2-byte void (``'|V2'``) in the npz,
  ``"bfloat16"`` in ``meta["dtypes"]``. They are read back through
  ``meta["dtypes"]`` (the JAX package's own loader cannot read them).

Self-healing, as in the JAX package: the save is atomic (``<tag>.tmp-<pid>``,
fsync, one rename), ``meta.json`` carries the state file's sha256,
``latest`` is rewritten only after the tag re-validates, transient I/O
errors are retried with backoff, and a load whose pointed-to tag is
corrupt quarantines it (``<tag>.corrupt-<time>``) and falls back to the
newest valid tag. Fault sites ``pre_save``, ``mid_save`` (``torn_file=``)
and ``post_save_pre_latest`` fire through ``resilience/fault_injection``.

The engine's optimizer updates the master params and moments in place, so
:func:`host_leaves` copies every leaf to host memory (synchronously, a copy
even on the CPU) before a save returns: a background writer never reads a
tensor the next step writes. ``engine.checkpoint_stats`` holds the
split times of the engine's last save and load.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..resilience.fault_injection import get_fault_injector
from ..utils.logging import log_dist, logger

#: v2: leaf paths recorded; v3: per-file sha256 checksums in meta (v2
#: files load without a checksum check)
FORMAT_VERSION = 3
LATEST_FILE = "latest"
STATE_FILE = "state.npz"
META_FILE = "meta.json"
#: suffix quarantined (corrupt) tags are renamed to; never loaded again
QUARANTINE_SUFFIX = ".corrupt"
#: default bounded retry-with-backoff for save I/O errors
SAVE_RETRIES = 3
RETRY_BACKOFF_S = 0.5
#: the dtype name numpy gives an ml_dtypes bfloat16 array (meta["dtypes"])
BF16 = "bfloat16"


class Leaf(NamedTuple):
    """One leaf of the saved tree: its JAX path, a host array (bf16 as
    ``'V2'``) and the dtype name ``meta["dtypes"]`` records."""
    path: str
    array: np.ndarray
    dtype: str


def _tag_for(engine) -> str:
    return f"global_step{engine.global_steps}"


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return               # platforms without O_RDONLY dir opens
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _retry_io(fn, what: str, retries: int, backoff_s: float):
    """Bounded retry-with-backoff for transient save I/O errors (NFS blips,
    quota races). Non-OSError failures propagate immediately."""
    attempt = 0
    while True:
        try:
            return fn()
        except OSError as e:
            if attempt >= retries:
                raise
            delay = backoff_s * (2 ** attempt)
            attempt += 1
            logger.warning(f"checkpoint {what} I/O error ({e}); retry "
                           f"{attempt}/{retries} in {delay:.1f}s")
            time.sleep(delay)


# ------------------------------------------------------------------ layout

def opt_layout(optimizer) -> Tuple[str, Optional[str]]:
    """(the prefix of the Adam state's ``count`` / ``mu`` / ``nu``, the
    schedule count's path or None) of the optax chain the JAX package
    builds for ``optimizer`` (``ops/optimizers.build_optimizer``); the JAX
    engine always hands optax a schedule, so a chain ends in its count."""
    from ..ops.optimizers import CompactAdamW
    if isinstance(optimizer, CompactAdamW):
        return "opt_state", None                 # adamw_compact
    if optimizer.decoupled:
        return "opt_state/0", "opt_state/2/count"   # optax.adamw
    if optimizer.weight_decay:
        # chain(add_decayed_weights, adam)
        return "opt_state/1/0", "opt_state/1/1/count"
    return "opt_state/0", "opt_state/1/count"    # optax.adam


def param_order(names: List[str]) -> List[int]:
    """Indices of the engine's flat names in ``jax.tree_util``'s order:
    at every level of the nested dict the keys sorted as strings."""
    return sorted(range(len(names)), key=lambda i: names[i].split("."))


def _jax_path(name: str) -> str:
    return name.replace(".", "/")


def state_leaves(engine) -> List[Tuple[str, Any, str]]:
    """The JAX engine's leaf list for the port's ``TrainState``: (path,
    value, dtype name) in the JAX order, where a value is a tensor of the
    engine's or a Python scalar."""
    st = engine.state
    order = param_order(engine._names)
    adam, sched = opt_layout(engine.optimizer)
    paths = [_jax_path(engine._names[i]) for i in order]

    def tensors(prefix, ts):
        return [(f"{prefix}/{p}", ts[i], _dtype_name(ts[i].dtype))
                for p, i in zip(paths, order)]

    out = [("step", st.step, "int32")]
    out += tensors("params", st.params)
    out.append((f"{adam}/count", st.opt_state.count, "int32"))
    out += tensors(f"{adam}/mu", st.opt_state.mu)
    out += tensors(f"{adam}/nu", st.opt_state.nu)
    if sched is not None:
        out.append((sched, st.opt_state.count, "int32"))
    ss = st.scale_state
    out += [("scale_state/scale", ss.scale, "float32"),
            ("scale_state/growth_tracker", ss.growth_tracker, "int32"),
            ("scale_state/hysteresis", ss.hysteresis, "int32"),
            ("scale_state/overflows", ss.overflows, "int32"),
            ("rng", st.rng, "uint32")]
    return out


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _to_host(value: Any, dtype: str) -> np.ndarray:
    """A leaf's host array as the JAX package writes it: a copy (the
    engine updates its tensors in place), bf16 as raw 2-byte void."""
    if not isinstance(value, torch.Tensor):
        return np.asarray(value, dtype=dtype)
    t = value.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).to("cpu", copy=True).numpy().view("V2")
    if dtype == "uint32":                       # the key's int64 words
        return t.to("cpu", copy=True).numpy().astype(np.uint32)
    return t.to("cpu", copy=True).numpy()


def host_leaves(engine) -> List[Leaf]:
    """Every leaf copied to host memory (the save's device -> host step);
    returns once the copies are complete. Starts the engine's
    ``checkpoint_stats["save"]``: ``d2h_s`` and the host ``bytes``."""
    t0 = time.perf_counter()
    leaves = [Leaf(p, _to_host(v, d), d) for p, v, d in state_leaves(engine)]
    engine.checkpoint_stats["save"] = {
        "d2h_s": time.perf_counter() - t0,
        "bytes": sum(lf.array.nbytes for lf in leaves)}
    return leaves


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A leaf read from the npz as a CPU tensor: bf16 by ``dtype`` (the
    file holds raw 2-byte void), uint32 key words as int64."""
    if dtype == BF16:
        if arr.dtype.itemsize != 2:
            raise ValueError(f"a bfloat16 leaf stored as {arr.dtype}")
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
            .view(torch.bfloat16)
    if arr.dtype == np.uint32:
        arr = arr.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(arr))


# --------------------------------------------------------------- the store

def save_state_tree(leaves: List[Leaf], ckpt_dir: str,
                    extra_meta: Optional[Dict] = None,
                    retries: Optional[int] = None,
                    retry_backoff_s: Optional[float] = None,
                    stats: Optional[Dict[str, float]] = None) -> None:
    """Save a leaf list (host arrays) with its paths, shapes and dtypes;
    ``stats`` (when given) receives ``write_s``, ``fsync_s`` and
    ``checksum_s``.

    Atomic: everything is written to ``<ckpt_dir>.tmp-<pid>``, fsynced, and
    promoted with one rename — a crash at any point leaves either the old
    tag or no tag, never a torn one. Fault-injection sites: ``pre_save``,
    ``mid_save`` (tears the state file first)."""
    retries = SAVE_RETRIES if retries is None else int(retries)
    retry_backoff_s = (RETRY_BACKOFF_S if retry_backoff_s is None
                       else float(retry_backoff_s))
    stats = {} if stats is None else stats
    inj = get_fault_injector()
    inj.maybe_fire("pre_save")

    tmp_dir = f"{ckpt_dir}.tmp-{os.getpid()}"
    shutil.rmtree(tmp_dir, ignore_errors=True)
    os.makedirs(tmp_dir)

    arrays = {f"leaf_{i:05d}": lf.array for i, lf in enumerate(leaves)}
    state_path = os.path.join(tmp_dir, STATE_FILE)
    t0 = time.perf_counter()
    _retry_io(lambda: np.savez(state_path, **arrays), STATE_FILE,
              retries, retry_backoff_s)
    stats["write_s"] = time.perf_counter() - t0
    inj.maybe_fire("mid_save", torn_file=state_path)
    t0 = time.perf_counter()
    _fsync_file(state_path)
    stats["fsync_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    checksum = _sha256_file(state_path)
    stats["checksum_s"] = time.perf_counter() - t0

    meta = {
        "format_version": FORMAT_VERSION,
        "n_leaves": len(leaves),
        "treedef": _treedef(leaves),
        "paths": [lf.path for lf in leaves],
        "shapes": [list(lf.array.shape) for lf in leaves],
        "dtypes": [lf.dtype for lf in leaves],
        "checksums": {STATE_FILE: checksum},
    }
    meta.update(extra_meta or {})
    meta_path = os.path.join(tmp_dir, META_FILE)

    def _write_meta():
        with open(meta_path, "w") as f:
            json.dump(meta, f, indent=2, default=str)

    _retry_io(_write_meta, META_FILE, retries, retry_backoff_s)
    _fsync_file(meta_path)

    # promote: the tag appears on disk complete or not at all
    if os.path.isdir(ckpt_dir):
        shutil.rmtree(ckpt_dir)
    os.rename(tmp_dir, ckpt_dir)
    _fsync_dir(os.path.dirname(ckpt_dir) or ".")


def _treedef(leaves: List[Leaf]) -> str:
    """A description of the saved tree (the JAX package records its
    ``PyTreeDef``; no reader of either package parses it)."""
    tops: Dict[str, int] = {}
    for lf in leaves:
        top = lf.path.split("/")[0]
        tops[top] = tops.get(top, 0) + 1
    return "TrainState(" + ", ".join(f"{k}: {n}" for k, n in tops.items()) \
        + ")"


def validate_checkpoint_dir(ckpt_dir: str, deep: bool = True
                            ) -> Tuple[bool, str]:
    """Structural (+ checksum when ``deep``) validation of one tag dir.
    Pre-checksum (format_version < 3) tags validate structurally only.
    Never raises on I/O: a tag vanishing mid-validation is "invalid"."""
    meta_path = os.path.join(ckpt_dir, META_FILE)
    if not os.path.isdir(ckpt_dir):
        return False, "missing directory"
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except FileNotFoundError:
        return False, f"missing {META_FILE}"
    except (OSError, ValueError) as e:
        return False, f"unreadable {META_FILE}: {e}"
    if "n_leaves" not in meta:
        return False, f"{META_FILE} lacks n_leaves"
    if not os.path.exists(os.path.join(ckpt_dir, STATE_FILE)):
        return False, f"missing {STATE_FILE}"
    if not deep:
        return True, "ok (structural)"
    for fname, want in (meta.get("checksums") or {}).items():
        fpath = os.path.join(ckpt_dir, fname)
        try:
            got = _sha256_file(fpath)
        except OSError as e:
            return False, f"unreadable {fname}: {e}"
        if got != want:
            return False, (f"checksum mismatch on {fname}: "
                           f"{got[:12]} != {want[:12]}")
    return True, "ok"


def quarantine_checkpoint(ckpt_dir: str, reason: str) -> Optional[str]:
    """Rename a corrupt tag out of the resume path (kept for forensics)."""
    dst = f"{ckpt_dir}{QUARANTINE_SUFFIX}-{int(time.time())}"
    try:
        os.rename(ckpt_dir, dst)
    except OSError as e:
        logger.error(f"could not quarantine {ckpt_dir}: {e}")
        return None
    logger.error(f"QUARANTINED corrupt checkpoint {ckpt_dir} -> {dst} "
                 f"({reason})")
    return dst


def _tag_step(tag: str) -> int:
    """Sort key: global_step<N> tags by step, anything else -1."""
    if tag.startswith("global_step"):
        try:
            return int(tag[len("global_step"):])
        except ValueError:
            pass
    return -1


def list_tags(load_dir: str) -> List[str]:
    """Candidate tags in ``load_dir``, newest first (step number, then
    mtime). tmp and quarantined dirs are excluded."""
    tags = []
    try:
        entries = os.listdir(load_dir)
    except OSError:
        return []
    for name in entries:
        full = os.path.join(load_dir, name)
        if not os.path.isdir(full):
            continue
        if QUARANTINE_SUFFIX in name or ".tmp-" in name:
            continue
        tags.append(name)

    def mtime(t):
        try:   # a peer may quarantine/clean the dir between listdir and here
            return os.path.getmtime(os.path.join(load_dir, t))
        except OSError:
            return 0.0

    return sorted(tags, key=lambda t: (_tag_step(t), mtime(t)), reverse=True)


def find_valid_tag(load_dir: str, preferred: Optional[str] = None,
                   quarantine: bool = True) -> Optional[str]:
    """Newest tag that passes validation; ``preferred`` (the ``latest``
    pointer) is tried first. Invalid candidates holding checkpoint files
    are quarantined on the way down; directories with none (a
    ``tensorboard/`` beside the tags) are skipped. ``quarantine=False``
    makes the walk read-only."""
    candidates = list_tags(load_dir)
    if preferred is not None:
        candidates = [preferred] + [t for t in candidates if t != preferred]
    for tag in candidates:
        ckpt_dir = os.path.join(load_dir, tag)
        ok, reason = validate_checkpoint_dir(ckpt_dir)
        if ok:
            return tag
        looks_like_ckpt = (
            os.path.exists(os.path.join(ckpt_dir, META_FILE))
            or os.path.exists(os.path.join(ckpt_dir, STATE_FILE)))
        if quarantine and looks_like_ckpt:
            quarantine_checkpoint(ckpt_dir, reason)
        else:
            logger.warning(f"skipping {ckpt_dir}: {reason}")
    return None


def publish_latest(save_dir: str, tag: str) -> None:
    """Atomically point ``latest`` at ``tag``, after the tag re-validates
    on disk (structurally: the checksums were computed from the bytes just
    written and fsynced; the load path does the deep pass). The commit
    point of the save: a crash before it leaves the previous ``latest``."""
    ckpt_dir = os.path.join(save_dir, tag)
    ok, reason = validate_checkpoint_dir(ckpt_dir, deep=False)
    if not ok:
        raise RuntimeError(
            f"refusing to publish '{tag}' as latest: {reason}")
    get_fault_injector().maybe_fire("post_save_pre_latest")
    latest_path = os.path.join(save_dir, LATEST_FILE)
    tmp = f"{latest_path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(tag)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, latest_path)
    _fsync_dir(save_dir)


def load_state_tree(ckpt_dir: str, target: List[Tuple[str, Any, str]]):
    """Check a tag against a target leaf list (:func:`state_leaves`) and
    return ``(leaves, meta)``: ``leaves`` yields each saved leaf as a CPU
    tensor, in order. The leaf count, every shape and every dtype are
    checked from the meta before anything is read. A format newer than
    this build's raises."""
    with open(os.path.join(ckpt_dir, META_FILE)) as f:
        meta = json.load(f)
    version = int(meta.get("format_version", 0))
    if version > FORMAT_VERSION:
        raise ValueError(
            f"checkpoint {ckpt_dir} has format_version {version}; this "
            f"build reads versions <= {FORMAT_VERSION} — upgrade the "
            f"framework to load it")
    if version < 2 and "paths" not in meta:
        log_dist(f"checkpoint {ckpt_dir} is format_version {version} "
                 f"(no 'paths' meta): zero_to_fp32 export will not work on "
                 f"it")
    n = meta["n_leaves"]
    if n != len(target):
        hint = (" (format_version 1 checkpoints from onebit-optimizer runs "
                "included comm_state leaves and cannot be loaded by this "
                "build — re-save with the current framework)"
                if version < 2 else "")
        raise ValueError(
            f"checkpoint has {n} leaves but target state has {len(target)} "
            f"— model/optimizer structure changed since save{hint}")
    shapes, dtypes = meta.get("shapes"), meta.get("dtypes")
    for i, (path, value, dtype) in enumerate(target):
        want = list(value.shape) if isinstance(value, torch.Tensor) else []
        if shapes is not None and list(shapes[i]) != want:
            raise ValueError(f"checkpoint leaf {i} shape {shapes[i]} != "
                             f"target {want} ({path})")
        if dtypes is not None and dtypes[i] != dtype:
            raise ValueError(f"checkpoint leaf {i} dtype {dtypes[i]} != "
                             f"target {dtype} ({path})")

    def leaves():
        with np.load(os.path.join(ckpt_dir, STATE_FILE)) as data:
            for i, (path, value, dtype) in enumerate(target):
                arr = data[f"leaf_{i:05d}"]
                want = tuple(value.shape) if isinstance(
                    value, torch.Tensor) else ()
                if tuple(arr.shape) != want:
                    raise ValueError(
                        f"checkpoint leaf {i} shape {arr.shape} != target "
                        f"{want} ({path})")
                yield _from_host(arr, dtype)

    return leaves(), meta


# ------------------------------------------------------------- the engine

def save_checkpoint(engine, save_dir: str, tag: Optional[str] = None,
                    client_state: Optional[dict] = None,
                    save_latest: bool = True) -> str:
    """Write a full training checkpoint; returns the tag's directory. The
    state is copied to host memory before this returns (an async writer
    then works from the copy while training goes on)."""
    tag = tag or _tag_for(engine)
    ckpt_dir = os.path.join(save_dir, tag)
    extra = {
        "global_steps": engine.global_steps,
        "global_samples": engine.global_samples,
        "skipped_steps": engine.skipped_steps,
        "client_state": client_state or {},
        "config": engine.config.to_dict(),
    }
    ck = engine._ckpt_engine
    if ck is None:
        from .checkpoint_engine import build_checkpoint_engine
        ck = engine._ckpt_engine = build_checkpoint_engine(
            "async" if engine.config.checkpoint.async_save else "sync")
    leaves = host_leaves(engine)
    ccfg = engine.config.checkpoint
    ck.save(leaves, ckpt_dir, extra_meta=extra,
            publish=(save_dir, tag) if save_latest else None,
            retries=ccfg.save_retries, retry_backoff_s=ccfg.retry_backoff_s,
            stats=engine.checkpoint_stats["save"])
    engine._last_save_dir = save_dir     # preemption urgent-save target
    log_dist(f"saved checkpoint {ckpt_dir}")
    return ckpt_dir


def _resolve_tag(load_dir: str, tag: Optional[str]) -> Optional[str]:
    """The tag to load: ``tag`` (validated, raising when invalid), or the
    newest valid one from the ``latest`` pointer (quarantining corrupt
    tags and healing the pointer); None when there is nothing to load."""
    if tag is not None:
        ok, reason = validate_checkpoint_dir(os.path.join(load_dir, tag))
        if not ok:
            raise ValueError(
                f"checkpoint tag '{tag}' in {load_dir} failed validation: "
                f"{reason}")
        return tag
    latest_path = os.path.join(load_dir, LATEST_FILE)
    if not os.path.exists(latest_path):
        # no commit pointer: unpublished tags (save_latest=False, or a
        # crash before the very first publish) are not trusted
        n = len(list_tags(load_dir))
        extra = f" ({n} unpublished tag(s) present)" if n else ""
        logger.warning(f"no '{LATEST_FILE}' file in {load_dir}; "
                       f"nothing loaded{extra}")
        return None
    with open(latest_path) as f:
        preferred = f.read().strip()
    tag = find_valid_tag(load_dir, preferred=preferred)
    if tag is None:
        logger.error(f"no valid checkpoint tag in {load_dir}; nothing "
                     f"loaded")
        return None
    if tag != preferred:
        logger.error(f"latest pointed at '{preferred}' but the newest "
                     f"VALID tag is '{tag}'; healing the pointer")
        try:
            publish_latest(load_dir, tag)
        except OSError as e:
            # read-only store: the fallback load still proceeds
            logger.warning(f"could not heal '{LATEST_FILE}': {e}")
    return tag


def load_checkpoint(engine, load_dir: str, tag: Optional[str] = None,
                    load_optimizer_states: bool = True,
                    load_lr_scheduler_states: bool = True,
                    load_module_only: bool = False
                    ) -> Tuple[Optional[str], dict]:
    """Restore the engine's state in place; returns (ckpt_path,
    client_state), (None, {}) when there is nothing to load.

    As the JAX engine: ``load_module_only`` or ``load_optimizer_states=
    False`` take the saved params and ``step`` and keep the engine's
    optimizer, loss-scale state and key; ``load_lr_scheduler_states=
    False`` sets ``step`` (which ``get_lr`` reads) to 0 and leaves the
    optimizer's count (the lr applied) as loaded."""
    # flush in-flight async saves of any engine in this process (the
    # writer may belong to another engine than the loader)
    from .checkpoint_engine import flush_all_pending
    flush_all_pending()
    t0 = time.perf_counter()
    tag = _resolve_tag(load_dir, tag)
    if tag is None:
        return None, {}
    validate_s = time.perf_counter() - t0
    ckpt_dir = os.path.join(load_dir, tag)
    st = engine.state
    target = state_leaves(engine)
    leaves, meta = load_state_tree(ckpt_dir, target)
    only_params = load_module_only or not load_optimizer_states

    read_s = h2d_s = 0.0
    nbytes = 0
    scalars: Dict[str, Any] = {}
    t_read = time.perf_counter()
    with torch.no_grad():
        for (path, value, _), host in zip(target, leaves):
            t = time.perf_counter()
            read_s += t - t_read
            nbytes += host.numel() * host.element_size()
            if not isinstance(value, torch.Tensor):
                scalars[path] = host.item()
            elif not only_params or path.startswith("params/"):
                value.copy_(host)
            t_read = time.perf_counter()
            h2d_s += t_read - t
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)
    h2d_s += time.perf_counter() - t_read
    adam, sched = opt_layout(engine.optimizer)
    step = int(scalars["step"])
    if only_params:
        engine.state = st._replace(step=step)
    else:
        from ..runtime.loss_scaler import LossScaleState
        engine.state = st._replace(
            step=step,
            opt_state=st.opt_state._replace(
                count=int(scalars[f"{adam}/count"])),
            scale_state=LossScaleState(
                scale=float(scalars["scale_state/scale"]),
                growth_tracker=int(scalars["scale_state/growth_tracker"]),
                hysteresis=int(scalars["scale_state/hysteresis"]),
                overflows=int(scalars["scale_state/overflows"])))
    if not load_lr_scheduler_states:
        # the LR schedule is a pure function of the step counter;
        # restarting the schedule fresh means restarting the counter
        engine.state = engine.state._replace(step=0)
    engine.global_steps = int(meta.get("global_steps", 0))
    engine.global_samples = int(meta.get("global_samples", 0))
    engine.skipped_steps = int(meta.get("skipped_steps", 0))
    engine.checkpoint_stats["load"] = {
        "validate_s": validate_s, "read_s": read_s, "h2d_s": h2d_s,
        "bytes": nbytes}
    log_dist(f"loaded checkpoint {ckpt_dir} (global_step "
             f"{engine.global_steps})")
    return ckpt_dir, meta.get("client_state", {})


def export_fp32_params(engine) -> Dict[str, np.ndarray]:
    """The params as ``{JAX path: fp32 ndarray}`` (the online analogue of
    ``zero_to_fp32``)."""
    return {_jax_path(engine._names[i]):
            engine.state.params[i].detach().float().cpu().numpy()
            for i in param_order(engine._names)}
