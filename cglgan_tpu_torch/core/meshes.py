"""Device meshes for the federation: the ``clients`` axis over
``torch.distributed``.

Port of ``cglgan_tpu/core/meshes.py``'s clients axis.  There a mesh is a
``jax.sharding.Mesh``, per-client state is placed split over its
``clients`` axis and GSPMD partitions one jitted round.  Here a mesh is one
process a card (NCCL, ``cuda:rank``), or a gloo process group on the host
when the caller asks for ``device="cpu"``: a
``torch.distributed.device_mesh.DeviceMesh`` of one ``clients`` dimension,
this rank's index and its device.  Each rank holds its block of the
per-client state and data shards; the generators are replicated, as in the
reference; the federated exchanges of ``fed/collectives.py`` compute the
rank-local partial and make the one collective the reference's round
lowers to.

Layouts (the reference's specs):
* ``P(CLIENTS)``: leaves ``(W, ...)``, a contiguous block of W / n rows a
  rank (the FedAvg family's per-worker state);
* ``P(None, CLIENTS)``: leaves ``(S, k, ...)``, each server's k clients
  split k / n a rank (the CGL and MD-GAN families' D stacks).  The port
  keeps those stacks flat ``(S * k, ...)``, so ``place`` takes
  ``groups=S`` and views a flat leaf as ``(S, k, ...)``;
* ``P()``: replicated.

Every collective goes through the mesh's ``Recorder``: its kind and the
bytes of each array it moves, in the order they were made.

Tensor parallelism over a ``model`` axis (``model_shards > 1``) is not
ported: ``fed_mesh`` raises naming its ROADMAP item.
"""
from __future__ import annotations

import os
import socket
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from cglgan_tpu_torch.utils.tree import tree_leaves, tree_unflatten

CLIENTS = "clients"
TP_NOT_PORTED = ("tensor parallelism over a `model` mesh axis "
                 "(model_shards > 1) is not ported yet (ROADMAP queue 1 "
                 "item 17)")


def P(*axes) -> tuple:
    """A partition spec: the mesh axis each leading dimension is split
    over (None: whole), as ``jax.sharding.PartitionSpec``."""
    return tuple(axes)


class Recorder:
    """The collectives a mesh made: ``(kind, [bytes of each array])`` in
    their order; ``take()`` returns them and starts a new log (taken around
    a round, the round's collectives)."""

    def __init__(self) -> None:
        self.log: List[tuple] = []

    def add(self, kind: str, tensors: Sequence[torch.Tensor]) -> None:
        self.log.append((kind, [t.numel() * t.element_size()
                                for t in tensors]))

    def take(self) -> List[tuple]:
        out, self.log = self.log, []
        return out


class Mesh:
    """A 1-D ``clients`` mesh: the ``DeviceMesh``, this rank's index in it,
    the world size, this rank's device and the recorder."""

    def __init__(self, device_mesh, device: torch.device) -> None:
        self.device_mesh = device_mesh
        self.group = device_mesh.get_group(CLIENTS)
        self.rank = dist.get_rank(self.group)
        self.size = dist.get_world_size(self.group)
        self.device = device
        self.recorder = Recorder()

    def block(self, n: int) -> slice:
        """This rank's contiguous block of an axis of ``n`` members; raises
        ValueError where the ranks do not divide it (the reference's
        ``device_put`` refuses such a sharding)."""
        if n % self.size:
            raise ValueError(f"a clients axis of {n} does not divide over "
                             f"a mesh of {self.size} ranks")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


def client_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The 1-D ``clients`` mesh over the initialised default process group
    (``spawn`` sets it up): one rank a card, ``cuda:rank``, or gloo ranks
    on the host with ``device="cpu"``.  ``n_devices`` must be the world
    size where given."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} ranks in a world of "
                         f"{world}")
    dev = torch.device("cuda", dist.get_rank()) if device is None \
        else torch.device(device)
    return Mesh(init_device_mesh(dev.type, (world,),
                                 mesh_dim_names=(CLIENTS,)), dev)


def fed_mesh(n_devices: Optional[int] = None, model_shards: int = 1,
             device=None) -> Mesh:
    """A (clients, model) mesh; ``model_shards == 1`` is the clients mesh.
    A ``model`` axis raises NotImplementedError."""
    if model_shards > 1:
        raise NotImplementedError(TP_NOT_PORTED)
    return client_mesh(n_devices, device)


def model_shards_of(mesh: Optional[Mesh]) -> int:
    """The ``model`` axis' size: 1, as no mesh here has one."""
    return 1


def _block_rows(x: torch.Tensor, mesh: Mesh, spec: tuple,
                groups: Optional[int]) -> torch.Tensor:
    if spec == P(CLIENTS):
        return x[mesh.block(x.shape[0])].clone()
    if spec != P(None, CLIENTS):
        raise ValueError(f"unsupported spec {spec}")
    if groups is None:                                  # (S, k, ...)
        return x[:, mesh.block(x.shape[1])].clone()
    sk = x.reshape((groups, -1) + tuple(x.shape[1:]))
    return sk[:, mesh.block(sk.shape[1])].reshape(
        (-1,) + tuple(x.shape[1:])).clone()


def _tensors(fn, tree):
    """``fn`` on every tensor of ``tree``: NamedTuples (a NetState, an
    AdamState), dicts, lists and tuples walked; None and other leaves (the
    round counter) kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tensors(fn, v) for v in tree))
    if isinstance(tree, dict):
        return {k: _tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tensors(fn, v) for v in tree)
    return tree


def place(tree, mesh: Optional[Mesh], spec: tuple, groups=None):
    """This rank's block of every leaf (``P(CLIENTS)``: of axis 0;
    ``P(None, CLIENTS)``: of axis 1 of ``(S, k, ...)`` leaves, or with
    ``groups=S`` of flat ``(S * k, ...)`` leaves viewed so, returned flat);
    ``P()`` and no mesh leave the tree as it is."""
    if mesh is None or spec == P():
        return tree
    return _tensors(lambda x: _block_rows(x, mesh, spec, groups), tree)


def _field(obj, name: str):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _with_field(obj, name: str, value):
    if isinstance(obj, dict):
        return {**obj, name: value}
    return obj._replace(**{name: value})


def _at_paths(state, layout: Dict[str, tuple], fn):
    """``state`` with the subtree at each dotted path of ``layout``
    replaced by ``fn(subtree, spec, groups)``; fields are attributes of
    NamedTuples or keys of the plain dicts a checkpoint holds."""
    for path, (spec, groups) in layout.items():
        names = path.split(".")

        def swap(obj, i):
            sub = _field(obj, names[i])
            new = fn(sub, spec, groups) if i + 1 == len(names) \
                else swap(sub, i + 1)
            return _with_field(obj, names[i], new)
        state = swap(state, 0)
    return state


def place_state(state, mesh: Optional[Mesh], layout: Dict[str, tuple]):
    """``place`` a whole state: ``layout`` maps dotted field paths
    (``"d"``, ``"g.opt"``) to ``(spec, groups)``; the other fields are
    replicated.  No mesh: the state as it is."""
    if mesh is None:
        return state
    return _at_paths(state, layout,
                     lambda sub, spec, groups: place(sub, mesh, spec, groups))


def gather_state(state, mesh: Optional[Mesh], layout: Dict[str, tuple],
                 dst: int = 0):
    """The inverse of ``place_state``: the whole state on rank ``dst``
    (each sharded leaf one ``gather``), None on the other ranks.  No mesh:
    the state as it is."""
    if mesh is None:
        return state

    def whole(sub, spec, groups):
        return _tensors(lambda x: gather_clients(
            x, mesh, groups if spec == P(None, CLIENTS) else 1, dst), sub)
    out = _at_paths(state, layout, whole)
    return out if mesh.rank == dst else None


def commit_tree(tree, mesh: Optional[Mesh]):
    """Identity.  The reference commits every leaf to the mesh so that jit
    dispatch stays on its fast path; torch has no committed placement to
    make: a leaf lives on its rank's device once it is made there."""
    return tree


# ---------------------------------------------------------------------------
# collectives: every one is recorded
# ---------------------------------------------------------------------------

def _pack(tensors: Sequence[torch.Tensor]) -> Dict[torch.dtype, tuple]:
    """Flat buffers, one a dtype: {dtype: (buffer, [(index, shape)])}."""
    by: Dict[torch.dtype, list] = {}
    for i, t in enumerate(tensors):
        by.setdefault(t.dtype, []).append(i)
    return {dt: (torch.cat([tensors[i].reshape(-1) for i in idx]),
                 [(i, tensors[i].shape) for i in idx])
            for dt, idx in by.items()}


def _unpack(bufs: Dict[torch.dtype, torch.Tensor], plan, n: int) -> list:
    out: List[Any] = [None] * n
    for dt, (_, places) in plan.items():
        flat, at = bufs[dt], 0
        for i, shape in places:
            size = shape.numel()
            out[i] = flat[at:at + size].reshape(shape)
            at += size
    return out


def all_reduce(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh]
               ) -> List[torch.Tensor]:
    """The sums over the ranks of ``tensors``, as ONE all-reduce of a flat
    bucket a dtype (XLA's fused tuple all-reduce).  No mesh: the tensors
    as they are."""
    tensors = list(tensors)
    if mesh is None:
        return tensors
    plan = _pack(tensors)
    for buf, places in plan.values():
        mesh.recorder.add("all_reduce", [tensors[i] for i, _ in places])
        dist.all_reduce(buf, group=mesh.group)
    return _unpack({dt: buf for dt, (buf, _) in plan.items()}, plan,
                   len(tensors))


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``x``, stacked ``(size, *x.shape)`` in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    out = torch.stack(parts)
    mesh.recorder.add("all_gather", [out])
    return out


def gather_clients(x: torch.Tensor, mesh: Optional[Mesh], groups: int = 1,
                   dst: Optional[int] = None):
    """The inverse of ``place(x, mesh, ..., groups)`` for one flat leaf:
    every rank's rows back in the unsharded order, ``(S * k, ...)``.
    ``dst``: only that rank gets the result (a ``gather``; the others get
    None); by default every rank does (an ``all_gather``).  No mesh: x."""
    if mesh is None:
        return x
    x = x.contiguous()
    if dst is None:
        parts = all_gather(x, mesh)
    else:
        lst = [torch.empty_like(x) for _ in range(mesh.size)] \
            if mesh.rank == dst else None
        dist.gather(x, lst, dst=dist.get_global_rank(mesh.group, dst),
                    group=mesh.group)
        mesh.recorder.add("gather", [x] * mesh.size)
        if mesh.rank != dst:
            return None
        parts = torch.stack(lst)
    rest = tuple(x.shape[1:])
    sk = parts.reshape((mesh.size, groups, -1) + rest).transpose(0, 1)
    return sk.reshape((-1,) + rest)


def exchange(sends: Sequence[tuple], recvs: Sequence[tuple], mesh: Mesh
             ) -> List[torch.Tensor]:
    """Point-to-point, all in one ``batch_isend_irecv``: ``sends`` [(peer
    rank, 1-D buffer)], ``recvs`` [(peer rank, numel, dtype)].  Returns
    the received buffers in ``recvs`` order (messages between two ranks
    match in the order they are posted)."""
    got = [torch.empty(n, dtype=dt, device=mesh.device)
           for _, n, dt in recvs]
    peer = lambda q: dist.get_global_rank(mesh.group, q)
    ops = [dist.P2POp(dist.isend, buf.contiguous(), peer(q), mesh.group)
           for q, buf in sends]
    ops += [dist.P2POp(dist.irecv, buf, peer(q), mesh.group)
            for (q, _, _), buf in zip(recvs, got)]
    for _, buf in sends:
        mesh.recorder.add("send", [buf])
    for buf in got:
        mesh.recorder.add("recv", [buf])
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return got


def move_rows(tree, rows_out: Dict[int, List[int]],
              rows_in: Dict[int, List[int]], keep: tuple, mesh: Mesh):
    """Move member rows of every leaf of ``tree`` (this rank's block)
    between ranks: to each peer q the local rows ``rows_out[q]``, in the
    order q takes them; from each peer q the rows that land at the local
    rows ``rows_in[q]``; ``keep`` = (dst rows, src rows) within this rank.
    One flat bucket a peer and dtype; rows nobody writes keep their
    value."""
    leaves = tree_leaves(tree)
    as_idx = lambda rows: torch.tensor(rows, dtype=torch.long,
                                       device=mesh.device)
    shapes = lambda n: [torch.Size((n,) + tuple(x.shape[1:]))
                        for x in leaves]

    def layout(n: int) -> list:
        """[(dtype, numel)] of the buckets of n rows, in ``_pack`` order."""
        by: Dict[torch.dtype, int] = {}
        for x, s in zip(leaves, shapes(n)):
            by[x.dtype] = by.get(x.dtype, 0) + s.numel()
        return list(by.items())

    sends = []
    for q, rows in rows_out.items():
        plan = _pack([x.index_select(0, as_idx(rows)) for x in leaves])
        sends += [(q, buf) for buf, _ in plan.values()]
    recvs = [(q, n, dt) for q, rows in rows_in.items()
             for dt, n in layout(len(rows))]
    got = iter(exchange(sends, recvs, mesh))
    out = [x.clone() for x in leaves]
    if keep[0]:
        dst, src = as_idx(keep[0]), as_idx(keep[1])
        for o, x in zip(out, leaves):
            o[dst] = x.index_select(0, src)
    for q, rows in rows_in.items():
        plan = {dt: (None, [(i, s) for i, (x, s) in
                            enumerate(zip(leaves, shapes(len(rows))))
                            if x.dtype == dt])
                for dt, _ in layout(len(rows))}
        parts = _unpack({dt: next(got) for dt in plan}, plan, len(leaves))
        dst = as_idx(rows)
        for o, part in zip(out, parts):
            o[dst] = part
    return tree_unflatten(tree, out)


# ---------------------------------------------------------------------------
# one process a rank
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, n: int, device_type: str, port: int,
               out_dir: str, threads: int, args: tuple) -> None:
    """A spawned rank: join the group, build the mesh, run ``fn(mesh,
    *args)``, save what it returns for the parent, leave the group."""
    if device_type == "cuda":
        # the ranks of one host find each other on the loopback interface
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
        backend = "nccl"
    else:
        torch.set_num_threads(threads)
        dev = torch.device("cpu")
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n, rank=rank)
    try:
        out = fn(client_mesh(n, dev), *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, n: int, device=None, *args) -> list:
    """Run ``fn(mesh, *args)`` on ``n`` ranks, one process each (start
    method ``spawn``; ``fn`` a module-level function, pickled by name) and
    return what each rank's ``fn`` returned, in rank order (CPU tensors
    only).  ``device``: None or ``"cuda"``, one NCCL rank a card, raising
    where fewer than ``n`` cards are present; ``"cpu"``: ``n`` gloo ranks
    on the host.  A rank that raises stops the others, and the error is
    raised here."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(f"a mesh of {n} ranks needs {n} CUDA devices "
                               f"and {have} are present; pass device='cpu' "
                               "for gloo ranks on the host")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    threads = max(1, torch.get_num_threads() // n)
    with tempfile.TemporaryDirectory(prefix="tpufed-mesh-") as tmp:
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, n, dev.type, _free_port(), tmp, threads,
                              args),
            nprocs=n, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(n)]
