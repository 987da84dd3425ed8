###############################################################################
# The scenario mesh (port of mpisppy_tpu/parallel/mesh.py).
#
# The reference's communication layer is mpi4py (ref:mpisppy/MPI.py), with
# scenarios block-partitioned over a communicator
# (ref:mpisppy/spbase.py:188-220) and every reduction an explicit
# Allreduce (ref:mpisppy/phbase.py:88-92).  The JAX package shards one
# process's arrays over a device mesh and lets XLA turn the p-weighted
# reductions into collectives.  Here the PyTorch idiom holds: one process
# per GPU, and the mesh is a torch.distributed process group (NCCL on the
# card, gloo on the CPU).  Each rank holds a contiguous slice of the
# scenario axis; ScenarioBatch.node_average/expectation and the
# feasibility, certification and slam reductions (core/batch.py) do their
# rank-local reduction as before and finish it with an all-reduce over
# the group.  `shard_batch` is the one seam: with no process group it is
# the serial path (a world of one without collectives); a group of one
# rank runs every collective as the identity, so its rows equal the
# unsharded rows bit for bit.
#
# A mesh's `size` is the multiple the scenario axis is padded to: the
# world size of a process group, or, in one process, the number of
# device slots of a virtual mesh (make_mesh(8) on one card, the
# single-process layout of the elastic re-shard, parallel/elastic.py).
#
# Collectives run on the current stream's order: the NCCL stream waits
# for the kernels launched before the call and the current stream waits
# for the collective, so no NCCL kernel runs beside a window kernel
# (the split design's cooperative grid needs every SM it asked for).
###############################################################################
from __future__ import annotations

import dataclasses
import datetime

import torch

from mpisppy_tpu_torch.core.batch import (  # noqa: F401  (re-exported)
    ShardedBatchUnsupported, require_unsharded,
)

def _dist():
    import torch.distributed as dist
    return dist


def _init_method(coordinator: str) -> str:
    """tcp://host:port and file:///path pass through; host:port becomes
    tcp://host:port (the JAX coordinator-address spelling)."""
    if "://" in coordinator:
        return coordinator
    return f"tcp://{coordinator}"


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int, device: str = "cuda",
                   timeout_s: float = 120.0) -> None:
    """Join the process group this rank's scenarios reduce over — the
    analog of the reference's `mpiexec` + COMM_WORLD bootstrap
    (ref:mpisppy/spin_the_wheel.py:224-242).  NCCL with one GPU per
    process (rank r on card r % device_count) unless device="cpu", which
    takes gloo.  Without CUDA and without device="cpu" it raises; a
    failed init raises too (there is no fallback to gloo or the CPU).
    coordinator_address: "tcp://host:port", "file:///path" (a FileStore:
    no port to collide on) or "host:port"."""
    dist = _dist()
    cpu = str(device) == "cpu"
    if not cpu:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_multihost: CUDA is not available; pass device='cpu' "
                "to run the mesh over gloo on the CPU")
        torch.cuda.set_device(int(process_id) % torch.cuda.device_count())
    dist.init_process_group(
        backend="gloo" if cpu else "nccl",
        init_method=_init_method(coordinator_address),
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=float(timeout_s)))


def shutdown() -> None:
    """Leave the process group (a no-op when none was joined)."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def process_local_slice(S: int) -> slice:
    """This rank's contiguous scenario block under the process-major
    layout (the reference's _calculate_scenario_ranks block partition,
    ref:mpisppy/spbase.py:188-220)."""
    P_ = process_count()
    if S % P_ != 0:
        raise ValueError(f"{S} scenarios not divisible by "
                         f"{P_} processes; pad first")
    per = S // P_
    i = process_index()
    return slice(i * per, (i + 1) * per)


def _failed(kind: str, e: Exception):
    """A collective that failed (a peer rank died: gloo reports the
    closed connection, NCCL its error) as the typed MeshDegraded the
    elastic fault domain unwinds on — raised, never retried elsewhere."""
    from mpisppy_tpu_torch.parallel.elastic import MeshDegraded
    return MeshDegraded("collective-failed",
                        detail=f"{kind}: {type(e).__name__}: {e}"[:300])


@dataclasses.dataclass(frozen=True)
class ScenarioMesh:
    """The scenario axis's layout: the process group (None = no
    collectives), this rank, the world size, the rank's device and the
    pad multiple `size` (see the module header); `calls` counts the
    collectives issued through it, by kind."""

    group: object | None
    rank: int
    world: int
    device: torch.device | None
    size: int
    calls: dict = dataclasses.field(
        default_factory=lambda: {"all_reduce": 0, "all_gather": 0},
        compare=False)

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """A new tensor: `t` reduced over the group ("sum"/"min"/"max";
        a bool reduces as int32: min = all, max = any)."""
        if self.group is None:
            return t
        dist = _dist()
        red = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
               "max": dist.ReduceOp.MAX}[op]
        is_bool = t.dtype == torch.bool
        buf = t.to(torch.int32) if is_bool else t.clone()
        buf = buf.contiguous()
        try:
            dist.all_reduce(buf, op=red, group=self.group)
        except RuntimeError as e:
            raise _failed("all_reduce", e) from e
        self.calls["all_reduce"] += 1
        return buf.to(torch.bool) if is_bool else buf

    def all_gather_cat(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` (equal shapes) concatenated along dim 0 in
        rank order."""
        if self.group is None:
            return t
        dist = _dist()
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.world)]
        try:
            dist.all_gather(parts, t, group=self.group)
        except RuntimeError as e:
            raise _failed("all_gather", e) from e
        self.calls["all_gather"] += 1
        return torch.cat(parts, dim=0)


def make_mesh(n_devices: int | None = None, devices=None) -> ScenarioMesh:
    """The scenario mesh.  With a joined process group: the whole world
    (n_devices must then be None or the world size, and `devices`, a
    survivor list, may only name a world of one's slots).  Without one:
    the serial path, a mesh of `n_devices` (or len(devices)) virtual
    slots in this process with no collectives.  n_devices=1 is always the
    serial path."""
    dist = _dist()
    joined = dist.is_available() and dist.is_initialized()
    size = len(devices) if devices is not None else n_devices
    if n_devices == 1 or not joined:
        return ScenarioMesh(group=None, rank=0, world=1, device=None,
                            size=max(1, int(size or 1)))
    world, rank = dist.get_world_size(), dist.get_rank()
    if world > 1 and size is not None and int(size) != world:
        raise ValueError(
            f"a process group of {world} ranks cannot take a mesh of "
            f"{size} slots: a live group does not shrink (relaunch at the "
            "survivor topology, parallel/elastic.py)")
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    return ScenarioMesh(group=dist.group.WORLD, rank=rank, world=world,
                        device=dev, size=world if size is None
                        else int(size))


def shard_batch(batch, mesh: ScenarioMesh, pad: bool = False):
    """This rank's slice of a ScenarioBatch (or VirtualBatch): every
    scenario-major field cut to rows [rank*per, (rank+1)*per), shared
    fields whole; the result carries the mesh and its offset, so its
    scenario reductions finish over the group.  Scenario-carrying fields
    are recognized by their batched rank (pad_to_multiple's rule).

    pad=True first re-pads the scenario axis to the mesh's multiple (the
    elastic re-shard onto a survivor set that does not divide S): pad
    lanes carry ZERO probability, so every p-weighted reduction is
    value-identical to the pre-loss layout."""
    S = batch.num_scenarios
    virtual = getattr(batch, "is_virtual", False)
    if S % mesh.size != 0:
        if not pad:
            raise ValueError(
                f"{S} scenarios not divisible by mesh size {mesh.size}; "
                "use core.batch.pad_to_multiple first"
                + (" (scengen: virtual_batch(pad_to=mesh.size))"
                   if virtual else ""))
        if virtual:
            from mpisppy_tpu_torch.scengen.virtual import repartition
            batch = repartition(batch, mesh.size)
        else:
            from mpisppy_tpu_torch.core.batch import pad_to_multiple
            batch = pad_to_multiple(batch, mesh.size)
        S = batch.num_scenarios
    per = S // mesh.world
    off = mesh.rank * per
    whole = per == S

    def take(x, batched_ndim):
        if x is None or whole:
            return x
        if hasattr(x, "vals"):   # ops.sparse.EllMatrix: its values
            return x.with_vals(take(x.vals, batched_ndim))
        return x[off:off + per] if x.ndim == batched_ndim else x

    if virtual:
        return dataclasses.replace(
            batch, p=take(batch.p, 1),
            node_of_slot=take(batch.node_of_slot, 2),
            mesh=mesh, scen_offset=off)
    qp = batch.qp
    if not whole:
        qp = dataclasses.replace(
            qp, c=take(qp.c, 2), q=take(qp.q, 2),
            A=take(qp.A, 3),
            bl=take(qp.bl, 2), bu=take(qp.bu, 2), l=take(qp.l, 2),
            u=take(qp.u, 2))
    return dataclasses.replace(
        batch, qp=qp,
        d_col=take(batch.d_col, 2), d_row=take(batch.d_row, 2),
        d_non=take(batch.d_non, 2), p=take(batch.p, 1),
        node_of_slot=take(batch.node_of_slot, 2),
        var_prob=take(batch.var_prob, 2),
        mesh=mesh, scen_offset=off)
