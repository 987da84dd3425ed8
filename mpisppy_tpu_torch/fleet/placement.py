###############################################################################
# Replica placement (port of mpisppy_tpu/fleet/placement.py;
# docs/serving.md fleet section).
#
# The scheduling unit is STRUCTURE, not tenant: two sessions solving
# the same model at the same scale intern to the same canonical arrays
# (serve/multiplex.StructureInterner), and the dispatch scheduler
# coalesces their oracle calls only when they share one interner pool
# — i.e. when they land on the SAME replica.  So the router derives a
# content-addressed routing key from the session spec (the projection
# of the interner digest that is knowable BEFORE the batch is built)
# and places:
#
#   1. AFFINITY   — a live replica with free slots that already holds
#                   the session's routing key (its interner already
#                   has the canonical structure; the megabatch
#                   coalescing is free there);
#   2. LEAST-LOADED — otherwise the live replica with the most free
#                   slots (ties broken by replica id for determinism);
#   3. DECLINE    — no live replica has a free slot: the session stays
#                   queued in FleetAdmission, uncharged.
###############################################################################
from __future__ import annotations

import hashlib

from mpisppy_tpu_torch.serve.protocol import SubmitRequest


def routing_key(spec: SubmitRequest) -> str:
    """The content-addressed placement key of a session spec: sessions
    with equal keys build identical shared structure (model module,
    scenario count, structure-affecting args), so equal keys coalesce
    on one replica.  A hash collision or a miss only costs
    coalescence, never correctness — exactly the interner contract."""
    ident = (spec.model, spec.num_scens, tuple(spec.args))
    return hashlib.sha1(repr(ident).encode()).hexdigest()[:16]


def choose(session, candidates: list) -> tuple:
    """Pick the replica for `session` from live candidates (each a
    fleet.replica.Replica with free slots).  Returns (replica, policy)
    with policy 'affinity' | 'least-loaded', or (None, 'none') when no
    candidate is given."""
    if not candidates:
        return None, "none"
    key = session.structure_key
    with_key = [r for r in candidates if key and r.holds(key)]
    if with_key:
        pool, policy = with_key, "affinity"
    else:
        pool, policy = candidates, "least-loaded"
    best = max(pool, key=lambda r: (r.free_slots(), r.id))
    return best, policy
