"""The device mesh on torch.distributed, and the cone-block data split.

Counterpart of the reference's sedumi_tpu/parallel/mesh.py.  The
reference runs one controller over a jax Mesh; the port runs SPMD, one
process per mesh position (as under torchrun or parallel.launch.run_spmd):
every rank calls the same code on the same data, and rank r sits at the
row-major coordinates r of the mesh shape.

Collectives run on the process group of one mesh axis (or of several),
created by every rank in one fixed order when the Mesh is built:
all_reduce, broadcast (one call per dtype, each tensor sent as itself),
all-gather, scatter and all-to-all.  Gloo implements each of them for
CUDA tensors (staged through the host), so ranks that share one card run
under gloo; NCCL refuses two ranks on one card and is used when each rank
has its own.

The deliberate difference from the reference: the IPM state stays
replicated on every rank, and the data axes split only the Schur
formation (ShardedAOp).  Each rank forms the partial augmented Schur
complement over its share of the split buckets, from the matching slice
of the scaling; the partial sums are all-reduced over the data axes; the
replicated parts (LP, COO buckets, buckets whose count the axis product
does not divide) are added once, after the all-reduce.  The split rule is
the reference's: a bucket is split when its count divides the product of
the data axes, COO buckets never.
"""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch
import torch.distributed as dist

from ..nt import Scaling
from ..opA import CooAOp, DenseAOp
from ..schur import build_schur
from ..structs import ConeVec

BLOCK_AXIS = "blocks"

# collectives run by this process, the host seconds spent in them (the
# card's queued work is waited for before the clock starts) and the bytes
# this rank receives from the others in them, as a ring all-reduce or
# all-gather and a direct broadcast, scatter or all-to-all move them
COMM = {"calls": 0, "seconds": 0.0, "bytes": 0}


def _collective(fn, t: torch.Tensor, received: float, *args, **kw) -> None:
    """fn(*args, **kw), counted in COMM; t is one of its tensors (on the
    device whose queue is waited for), `received` its bytes in."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    fn(*args, **kw)
    COMM["seconds"] += time.perf_counter() - t0
    COMM["calls"] += 1
    COMM["bytes"] += int(received)


def _axes(axis) -> tuple:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


class Mesh:
    """This rank's view of a named mesh over the default process group.

    shape: ordered {axis name: size}, whose product is the world size;
    device: where this rank's tensors live."""

    def __init__(self, shape: dict, device):
        self.shape = {str(k): int(v) for k, v in shape.items()}
        self.axis_names = tuple(self.shape)
        dims = tuple(self.shape.values())
        self.size = int(np.prod(dims))
        if not dist.is_initialized() or dist.get_world_size() != self.size:
            raise ValueError(f"mesh {self.shape} needs a process group of "
                             f"{self.size} ranks")
        self.rank = dist.get_rank()
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.unravel_index(self.rank,
                                                                 dims))))
        self.device = torch.device(device)
        # host decisions travel as CPU tensors where the backend takes them
        # (gloo), saving the card a round trip
        self._flag_device = torch.device("cpu") \
            if "gloo" in dist.get_backend() else self.device
        # every subset of axes gets its groups, built by every rank in the
        # same order (dist.new_group is collective over the world)
        self._groups = {}
        grid = np.arange(self.size).reshape(dims)
        for k in range(1, len(dims) + 1):
            for sub in itertools.combinations(range(len(dims)), k):
                names = tuple(self.axis_names[i] for i in sub)
                if k == len(dims):
                    self._groups[names] = None          # the world group
                    continue
                moved = np.moveaxis(grid, list(sub), list(range(k)))
                blocks = moved.reshape(int(np.prod([dims[i] for i in sub])),
                                       -1)
                mine = None
                for col in range(blocks.shape[1]):
                    ranks = [int(r) for r in blocks[:, col]]
                    g = dist.new_group(ranks)
                    if self.rank in ranks:
                        mine = g
                self._groups[names] = mine

    def axis_size(self, axis) -> int:
        return int(np.prod([self.shape[a] for a in _axes(axis)]))

    def axis_index(self, axis) -> int:
        """This rank's row-major position along the axis (or the product
        of several axes, the first one slowest)."""
        idx = 0
        for a in _axes(axis):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def _group(self, axis):
        names = _axes(axis)
        key = tuple(a for a in self.axis_names if a in names)
        return self._groups[key]

    def root(self, axis) -> int:
        """The global rank of the member of this rank's group of the axis
        (or axes) at coordinate 0 along it: the group's root."""
        names = _axes(axis)
        coords = [0 if a in names else self.coords[a]
                  for a in self.axis_names]
        return int(np.ravel_multi_index(coords, tuple(self.shape.values())))

    def psum(self, t: torch.Tensor, axis) -> torch.Tensor:
        """The sum of t over the ranks of the axis (in place on a
        contiguous t, which is returned)."""
        n = self.axis_size(axis)
        if n == 1:
            return t
        t = t.contiguous()
        _collective(dist.all_reduce, t, 2 * t.nbytes * (n - 1) / n, t,
                    group=self._group(axis))
        return t

    def all_gather(self, t: torch.Tensor, axis) -> torch.Tensor:
        """[n, *t.shape]: every rank's t along the axis, by position."""
        n = self.axis_size(axis)
        if n == 1:
            return t[None]
        src = t.contiguous().reshape(-1)
        out = torch.empty(n * src.numel(), dtype=t.dtype, device=t.device)
        _collective(dist.all_gather_into_tensor, out, src.nbytes * (n - 1),
                    out, src, group=self._group(axis))
        return out.reshape((n,) + tuple(t.shape))

    def scatter(self, chunks, like: torch.Tensor, axis) -> torch.Tensor:
        """Chunk i of the axis group's root (self.root(axis)) on the rank
        at position i along the axis: chunks is the root's list of n
        tensors shaped as `like` (None on the other ranks)."""
        if self.axis_size(axis) == 1:
            return chunks[0]
        out = torch.empty_like(like)
        src = self.root(axis)
        got = 0 if self.rank == src else out.nbytes
        _collective(dist.scatter, out, got, out,
                    [c.contiguous() for c in chunks] if chunks else None,
                    src=src, group=self._group(axis))
        return out

    def all_to_all(self, t: torch.Tensor, sends: list, recvs: list,
                   axis) -> torch.Tensor:
        """Rows of t (dim 0) to the ranks of the axis by position: sends[i]
        rows to the rank at position i, recvs[i] rows from it, in position
        order."""
        me = self.axis_index(axis)
        row = t[0].nbytes if t.shape[0] else 0
        out = torch.empty((sum(recvs),) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        if self.axis_size(axis) == 1:
            return out.copy_(t)
        _collective(dist.all_to_all_single, out,
                    row * (sum(recvs) - recvs[me]), out, t.contiguous(),
                    list(recvs), list(sends), group=self._group(axis))
        return out

    def broadcast(self, tensors: list, axis=None) -> list:
        """Global rank 0's values of the tensors, on every rank (axis
        None) or on the ranks of its group of `axis` (called by those
        only), in one collective per dtype: each tensor travels as
        itself."""
        group = None if axis is None else self._group(axis)
        n = self.size if axis is None else self.axis_size(axis)
        out = list(tensors)
        if n == 1:
            return out
        for dt in dict.fromkeys(t.dtype for t in tensors):
            idx = [i for i, t in enumerate(tensors) if t.dtype == dt]
            flat = torch.cat([tensors[i].detach().reshape(-1)
                              for i in idx]).contiguous()
            _collective(dist.broadcast, flat,
                        0 if self.rank == 0 else flat.nbytes, flat, src=0,
                        group=group)
            pos = 0
            for i in idx:
                k = tensors[i].numel()
                out[i] = flat[pos:pos + k].reshape(tensors[i].shape)
                pos += k
        return out

    def agree(self, flag) -> bool:
        """Global rank 0's value of a host decision, on every rank."""
        t = torch.tensor([1.0 if bool(flag) else 0.0], dtype=torch.float64,
                         device=self._flag_device)
        return bool(self.broadcast([t])[0].item())

    def all_true(self, flag) -> bool:
        """Whether a host flag holds on every rank of the mesh, the same
        answer on every rank (an all-reduce MIN)."""
        t = torch.tensor([1.0 if bool(flag) else 0.0], dtype=torch.float64,
                         device=self._flag_device)
        if self.size > 1:
            _collective(dist.all_reduce, t,
                        2 * t.nbytes * (self.size - 1) / self.size, t,
                        op=dist.ReduceOp.MIN)
        return bool(t.item())


def make_mesh(n_devices: int | None = None, axis: str = BLOCK_AXIS,
              shape: dict | None = None, device="cuda") -> Mesh:
    """The reference's make_mesh (mesh.py:34): a 1-axis mesh of n_devices
    (the world size by default) named `axis`, or the ordered multi-axis
    `shape` (e.g. {"hosts": 2, "blocks": 4}).  The process group must
    already hold exactly that many ranks."""
    if shape:
        return Mesh(shape, device)
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    return Mesh({axis: n}, device)


def replicate(tree, mesh: Mesh):
    """Tensors of a (nested) tuple moved to this rank's device: the state
    and data are replicated on every rank."""
    if isinstance(tree, torch.Tensor):
        return tree.to(mesh.device)
    if isinstance(tree, tuple):
        vals = [replicate(v, mesh) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else tuple(vals)
    return tree


def _split(count: int, n: int) -> bool:
    """The reference's rule: a bucket splits when n divides its count."""
    return bool(count) and count % n == 0


def _local(t: torch.Tensor, count: int, mesh: Mesh, axis, dim: int = 0):
    """This rank's share of a bucket tensor along `dim` (count blocks of
    t.shape[dim] // count entries each), or all of it when not split."""
    n = mesh.axis_size(axis)
    if not _split(count, n):
        return t
    w = t.shape[dim] // n
    return t.narrow(dim, mesh.axis_index(axis) * w, w)


def shard_conevec(v: ConeVec, mesh: Mesh, axis=BLOCK_AXIS) -> ConeVec:
    """This rank's share of a cone vector: the split Lorentz and PSD
    buckets' slices, the LP part and the unsplit buckets whole."""
    return ConeVec(l=v.l,
                   q=tuple(_local(a, a.shape[0], mesh, axis) for a in v.q),
                   s=tuple(_local(a, a.shape[0], mesh, axis) for a in v.s))


def shard_state(state, mesh: Mesh, axis=BLOCK_AXIS):
    """The IPM state for a mesh step.  Unlike the reference's, it stays
    replicated on every rank (module docstring): only the Schur formation
    is split, by the operator (shard_coo_aop)."""
    return replicate(state, mesh)


class ShardedAOp:
    """An operator whose Schur formation is split over the data axes.

    apply/adj/adj_y and every other attribute are the replicated
    operator's (`full`).  schur.build_schur calls schur(): the split
    buckets' partial sum from this rank's slice (`local`), all-reduced
    over the axes, plus the replicated parts (`rest`), added once."""

    def __init__(self, full, mesh: Mesh, axis, local, rest, q_split,
                 s_split):
        self.full = full
        self.mesh = mesh
        self.axis = axis
        self.local = local
        self.rest = rest
        self.q_split = q_split
        self.s_split = s_split

    def __getattr__(self, name):
        return getattr(self.full, name)

    def _scalings(self, S: Scaling):
        """(local, rest) Scalings matching the two operators' buckets."""
        mesh, axis = self.mesh, self.axis

        def pick(vals, split, want):
            return tuple(_local(v, v.shape[0], mesh, axis) if want else v
                         for v, s in zip(vals, split) if s == want)

        def parts(want):
            q = {f: pick(getattr(S, f), self.q_split, want)
                 for f in ("q_wb", "q_eta2", "q_u", "q_uinv", "q_lam")}
            s = {f: pick(getattr(S, f), self.s_split, want)
                 for f in ("s_r", "s_rinv", "s_lam")}
            empty = S.d_l[:0]
            return Scaling(d_l=empty if want else S.d_l,
                           lam_l=empty if want else S.lam_l, **q, **s)

        return parts(True), parts(False)

    def schur(self, S: Scaling) -> torch.Tensor:
        s_loc, s_rest = self._scalings(S)
        M = self.mesh.psum(build_schur(self.local, s_loc), self.axis)
        return M + build_schur(self.rest, s_rest)


def _split_parts(aop, mesh: Mesh, axis):
    """(q_split, local_q, rest_q): the reference's split rule over the
    Lorentz buckets, this rank's slices of the split ones with their
    shapes, and the others whole."""
    n = mesh.axis_size(axis)
    q_split = [_split(c, n) for c, _ in aop.q_shapes]
    local_q = [(_local(a, c, mesh, axis, dim=1), (c // n, d))
               for a, (c, d), s in zip(aop.Aq, aop.q_shapes, q_split) if s]
    rest_q = [(a, sh) for a, sh, s in zip(aop.Aq, aop.q_shapes, q_split)
              if not s]
    return q_split, local_q, rest_q


def shard_aop(aop: DenseAOp, mesh: Mesh, axis=BLOCK_AXIS) -> ShardedAOp:
    """The reference's shard_aop (mesh.py:70) for the all-dense operator:
    Lorentz and PSD buckets whose count divides the axis product split
    their formation; Al and the other buckets stay replicated.  `axis`
    may be a tuple of mesh axes (their product)."""
    n = mesh.axis_size(axis)
    q_split, local_q, rest_q = _split_parts(aop, mesh, axis)
    s_split = [_split(k, n) for k, _ in aop.s_shapes]
    local_s = [(_local(a, k, mesh, axis, dim=1), (k // n, d))
               for a, (k, d), s in zip(aop.As, aop.s_shapes, s_split) if s]
    rest_s = [(a, sh) for a, sh, s in zip(aop.As, aop.s_shapes, s_split)
              if not s]
    local = DenseAOp(Al=aop.Al[:, :0], Aq=[a for a, _ in local_q],
                     As=[a for a, _ in local_s],
                     q_shapes=[sh for _, sh in local_q],
                     s_shapes=[sh for _, sh in local_s])
    rest = DenseAOp(Al=aop.Al, Aq=[a for a, _ in rest_q],
                    As=[a for a, _ in rest_s],
                    q_shapes=[sh for _, sh in rest_q],
                    s_shapes=[sh for _, sh in rest_s])
    return ShardedAOp(aop, mesh, axis, local, rest, q_split, s_split)


def shard_coo_aop(aop: CooAOp, mesh: Mesh, axis=BLOCK_AXIS) -> ShardedAOp:
    """The reference's shard_coo_aop (mesh.py:96): the dense PSD buckets
    and Lorentz buckets split by the rule; COO buckets (their formation is
    one gather already) and Al stay replicated."""
    n = mesh.axis_size(axis)
    q_split, local_q, rest_q = _split_parts(aop, mesh, axis)
    s_split = [meta[0] == "dense" and _split(meta[1], n)
               for meta in aop.s_meta]
    local_s, rest_s = [], []
    for part, meta, s in zip(aop.s_parts, aop.s_meta, s_split):
        if s:
            rep, k, d, G, pad2, T = meta
            local_s.append(({"mat": _local(part["mat"], k, mesh, axis,
                                           dim=1)},
                            (rep, k // n, d, G, pad2, T)))
        else:
            rest_s.append((part, meta))
    local = CooAOp(Al=aop.Al[:, :0], Aq=[a for a, _ in local_q],
                   s_parts=[p for p, _ in local_s],
                   q_shapes=[sh for _, sh in local_q],
                   s_meta=[mt for _, mt in local_s])
    rest = CooAOp(Al=aop.Al, Aq=[a for a, _ in rest_q],
                  s_parts=[p for p, _ in rest_s],
                  q_shapes=[sh for _, sh in rest_q],
                  s_meta=[mt for _, mt in rest_s])
    return ShardedAOp(aop, mesh, axis, local, rest, q_split, s_split)


def world_size() -> int:
    """The default process group's size, 1 without one."""
    return dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for v in tree for leaf in _leaves(v)]


def _refill(tree, it):
    if isinstance(tree, torch.Tensor):
        return next(it)
    vals = [_refill(v, it) for v in tree]
    return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)


def from_root(mesh: Mesh, tree):
    """A (nested) tuple of tensors with global rank 0's values on every
    rank, in one broadcast: the solver keeps the replicas of the iterate
    and of the step's statistics equal with it, since the card's atomic
    sums (index_add_) round differently on each rank."""
    return _refill(tree, iter(mesh.broadcast(_leaves(tree))))
