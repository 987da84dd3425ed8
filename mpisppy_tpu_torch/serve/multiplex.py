###############################################################################
# Cross-session multiplexing (port of mpisppy_tpu/serve/multiplex.py;
# docs/serving.md).
#
# Two mechanisms make many tenants share one wheel efficiently:
#
# 1. STRUCTURE INTERNING — the dispatch scheduler's mergeable-identity
#    key (dispatch/scheduler._request_key) treats SHARED QP structure
#    (a broadcast A, the ELL column index array, a ConeSpec, shared
#    bound vectors) by OBJECT identity: exact and free within one
#    session, where every oracle call threads the same arrays, but
#    blind across sessions — two tenants solving the same model build
#    equal-but-distinct arrays and would never coalesce.  The interner
#    is a content-addressed pool (dtype, shape, byte digest): each
#    session's batch canonicalizes its shared structure ONCE at build
#    time, after which equal structure IS the same object and
#    cross-session requests land in one coalescing window — megabatch
#    sharing across tenants through the unchanged dispatch scheduler.  A
#    digest miss only costs coalescence, never correctness (the key
#    still separates them).
#
# 2. EXCHANGE INTERLEAVING — the async hub splits every sync
#    into a device-issue half and a host-complete half.  The
#    ExchangeRing is a token gate over the host-complete half shared
#    by every session in the server: one session at a time completes
#    its host exchange while the other sessions' issue halves keep
#    feeding the device queue — one wheel advances several tenants
#    between host exchanges.  MultiplexedAsyncHub is an AsyncPHHub
#    wired to the ring via options['exchange_ring'].
###############################################################################
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import threading

import numpy as np
import torch


# ---------------------------------------------------------------------------
# structure interning
# ---------------------------------------------------------------------------
def _host(x) -> np.ndarray:
    """The bytes the digest reads: a tensor's after .detach().cpu(),
    anything else through numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().contiguous().numpy()
    return np.asarray(x)


def _device(x) -> str:
    return str(x.device) if isinstance(x, torch.Tensor) else "host"


def _sha1(host: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(host).tobytes()).hexdigest()


class StructureInterner:
    """Content-addressed pool of shared-structure arrays.  The FIRST
    array seen for a digest becomes the canonical object every later
    equal array interns to.  The pool is BOUNDED (`max_entries`, FIFO
    eviction): clients control problem diversity, so an unbounded pool
    would pin every distinct constraint matrix ever served — and by
    design an evicted entry only costs coalescence for later equal
    structure, never correctness (the scheduler key still separates
    non-identical objects).

    A key is (dtype, shape, device, sha1 of the bytes): a CPU tensor
    never interns to a CUDA one.  digests() reports what the JAX
    package's interner reports for the same arrays (the sha1's first 16
    hex digits; for an interned object, the digest of its JAX-form key,
    which carries no device), so a router's placement reads either.

    A canonical tensor is shared by every session that interned an equal
    one: it is read-only by contract (the batch code builds new tensors
    and never writes a shared structure field in place)."""

    def __init__(self, max_entries: int = 256):
        self.max_entries = int(max_entries)
        self._lock = threading.Lock()
        self._pool: dict = {}     # guarded-by: _lock (key -> value)
        self._digest: dict = {}   # guarded-by: _lock (key -> digest)
        self._hits = 0            # guarded-by: _lock
        self._misses = 0          # guarded-by: _lock
        self._evictions = 0       # guarded-by: _lock

    def _lookup(self, key, value, digest):
        with self._lock:
            hit = self._pool.get(key)
            if hit is not None:
                self._hits += 1
                return hit
            while len(self._pool) >= self.max_entries:
                old = next(iter(self._pool))
                self._pool.pop(old)
                self._digest.pop(old, None)
                self._evictions += 1
            self._pool[key] = value
            self._digest[key] = digest
            self._misses += 1
            return value

    def intern(self, x):
        """Canonical object for `x` (a tensor or any array); non-array
        values pass through untouched."""
        if x is None or not hasattr(x, "shape"):
            return x
        host = _host(x)
        sha = _sha1(host)
        key = (str(host.dtype), tuple(host.shape), _device(x), sha)
        return self._lookup(key, x, sha[:16])

    def intern_object(self, obj):
        """ConeSpec-style frozen dataclasses: interned by their array
        fields' digests and device (the pool stores the first
        instance)."""
        if obj is None:
            return None
        parts, devices = [], set()
        for f in getattr(obj, "__dataclass_fields__", {}):
            if f.startswith("_"):
                continue            # caches (ConeSpec._csr), not content
            v = getattr(obj, f)
            if hasattr(v, "shape"):
                host = _host(v)
                parts.append((f, str(host.dtype), tuple(host.shape),
                              _sha1(host)))
                devices.add(_device(v))
            else:
                parts.append((f, repr(v)))
        jax_key = ("obj", type(obj).__name__, tuple(parts))
        digest = "obj:" + hashlib.sha1(
            repr(jax_key).encode()).hexdigest()[:16]
        return self._lookup(jax_key + (tuple(sorted(devices)),), obj,
                            digest)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._pool), "hits": self._hits,
                    "misses": self._misses,
                    "evictions": self._evictions}

    def digests(self) -> tuple:
        """The content digests currently held: a fleet router's
        placement-affinity key — a session whose canonical structure is
        already in a replica's pool coalesces there for free, so
        placement prefers that replica."""
        with self._lock:
            return tuple(self._digest[k] for k in self._pool)


#: the process-default interner every serve session shares
_default_interner = StructureInterner()


def default_interner() -> StructureInterner:
    return _default_interner


def intern_qp(qp, d_col=None, interner: StructureInterner | None = None):
    """Canonicalize a BoxQP's SHARED (unbatched) structure so the
    dispatch scheduler's identity-keyed coalescing fires across
    sessions: the constraint matrix (dense 2-D, or an EllMatrix's
    cols/vals), the cone spec, and any unbatched bound/cost vectors.
    Batched (per-lane) fields pass through untouched — they concatenate
    per request and carry no identity."""
    it = interner or _default_interner
    A = qp.A
    if hasattr(A, "vals"):          # EllMatrix
        repl = {"cols": it.intern(A.cols)}
        if getattr(A.vals, "ndim", 3) == 2:
            repl["vals"] = it.intern(A.vals)
        A = dataclasses.replace(A, **repl)
    elif getattr(A, "ndim", 0) == 2:
        A = it.intern(A)
    fields = {"A": A}
    for name in ("c", "q", "bl", "bu", "l", "u"):
        v = getattr(qp, name)
        if getattr(v, "ndim", 0) == 1:
            fields[name] = it.intern(v)
    cones = getattr(qp, "cones", None)
    if cones is not None:
        fields["cones"] = it.intern_object(cones)
    qp = dataclasses.replace(qp, **fields)
    if d_col is None:
        return qp
    if getattr(d_col, "ndim", 0) == 1:
        d_col = it.intern(d_col)
    return qp, d_col


def intern_batch(batch, interner: StructureInterner | None = None):
    """Canonicalize a ScenarioBatch's shared structure (the engine
    calls this once per session at build time), so every downstream
    oracle QP derived from it shares identity with equal-structure
    batches of OTHER sessions."""
    qp, d_col = intern_qp(batch.qp, batch.d_col, interner)
    return dataclasses.replace(batch, qp=qp, d_col=d_col)


# ---------------------------------------------------------------------------
# exchange interleaving
# ---------------------------------------------------------------------------
class ExchangeRing:
    """Token gate over the async hub's host-complete half: at most one
    session completes its host exchange at a time; everyone else's
    device-issue halves keep the wheel fed.  Contention is counted so
    the serve stats show how often tenants actually interleaved."""

    def __init__(self):
        self._sem = threading.Semaphore(1)
        self._lock = threading.Lock()
        self._grants = 0          # guarded-by: _lock
        self._waits = 0           # guarded-by: _lock

    @contextlib.contextmanager
    def exchange(self):
        contended = not self._sem.acquire(blocking=False)
        if contended:
            self._sem.acquire()
        with self._lock:
            self._grants += 1
            if contended:
                self._waits += 1
        try:
            yield
        finally:
            self._sem.release()

    def stats(self) -> dict:
        with self._lock:
            return {"grants": self._grants, "waits": self._waits}


def make_multiplexed_hub_class():
    """AsyncPHHub subclass whose host-complete half runs under the
    ExchangeRing in options['exchange_ring'] (absent -> plain async
    behavior).  Built lazily: importing serve.multiplex does not load
    the cylinders package."""
    from mpisppy_tpu_torch.cylinders import hub as hub_mod

    class MultiplexedAsyncHub(hub_mod.AsyncPHHub):
        def _exchange_gate(self):
            ring = self.options.get("exchange_ring")
            if ring is None:
                return contextlib.nullcontext()
            return ring.exchange()

    return MultiplexedAsyncHub
