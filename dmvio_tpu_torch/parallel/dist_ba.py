"""Distributed windowed bundle adjustment: the point axis over shards.

Counterpart of dmvio_tpu/parallel/dist_ba.py. The reference's only
parallel axis is the residual/point axis (IndexThreadReduce workers on
one CPU); dmvio_tpu maps it onto a device mesh and lets GSPMD partition
its jitted programs. PyTorch has no GSPMD, so the port shards explicitly,
with the same placement:

  * POINTS and the [F, P] pair incidence split into equal contiguous
    shards along the point axis (capacities are powers of two);
  * FRAMES, images, the priors and the camera solve are replicated: every
    shard's device holds its own copy;
  * per-point work (linearization with kernel K1, the per-point blocks
    H_fd / H_dd / b_d, the back-substitution) runs on each shard;
  * camera-sized partials (H, b, the point-Schur terms, energies and
    counts) are summed across shards in a fixed shard order inside one
    process, then with all_reduce(SUM) across the ranks of a process
    group; per-point results are concatenated in shard order, then
    all_gathered across ranks.

The window BA programs (models/ba.py, models/vio_ba.py) take either plain
tensors (one shard on their own device, the unsharded call) or the Placed
values this module's Placer makes; the same code runs both. A Placer can
put several shards on ONE device (an explicit device list), so that one
card, or the CPU, stands in for a mesh of n devices.

No float atomics and no nondeterministic reduction: every rank of a
process group gets the same bits from its collectives, so ranks that run
the same host pipeline stay in lockstep.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from dmvio_tpu_torch import device as resolve_device
from dmvio_tpu_torch.utils.camera import Calib


class Mesh(NamedTuple):
    """A 2-D grid of shard devices. Under a process group row r holds rank
    r's shards (the reference's (process, local device) layout)."""

    devices: np.ndarray           # [a, b] of torch.device
    axis_names: tuple


def _grid(n: int):
    """The reference's 2-D shape rule: (n // 2, 2) when n is even, else
    (n, 1)."""
    return (n // 2, 2) if n % 2 == 0 else (n, 1)


def _norm(d) -> torch.device:
    """A device with its index (tensors report "cuda:0", never "cuda")."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _in_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def make_mesh(n_devices: int, name_a: str = "dp", name_b: str = "mp",
              device=None) -> Mesh:
    """Mesh of n shard devices of the kind `device` names (None: CUDA).

    Under a multi-process group the mesh spans every rank with the rank on
    the first axis, and n_devices must be 0 (one shard per rank) or a
    multiple of the world size (n / world shards per rank, on the rank's
    own device). In one process on CUDA, n cards (0: every card; fewer
    than n raises); on the CPU, n shards of the CPU stand in for the
    reference's virtual devices."""
    dev = _norm(resolve_device(device))
    if _in_group() and dist.get_world_size() > 1:
        world = dist.get_world_size()
        if n_devices not in (0,) and n_devices % world:
            raise RuntimeError(
                f"multi-process mesh must span all {world} ranks evenly "
                f"(got n_devices={n_devices}; pass 0 for one per rank)")
        local = max(1, n_devices // world)
        devs = np.empty((world, local), dtype=object)
        devs[:] = dev
        return Mesh(devs, (name_a, name_b))
    if dev.type == "cuda":
        have = torch.cuda.device_count()
        n = n_devices or have
        if have < n:
            raise RuntimeError(
                f"need {n} CUDA devices, have {have} (pass a Placer an "
                "explicit device list to hold several shards on one card)")
        flat = [torch.device("cuda", i) for i in range(n)]
    else:
        n = n_devices or 1
        flat = [dev] * n
    devs = np.empty(n, dtype=object)
    devs[:] = flat
    return Mesh(devs.reshape(_grid(n)), (name_a, name_b))


def tree_to(x, dev):
    """Move every tensor of nested NamedTuples, tuples, lists and Calibs to
    `dev` (a tensor already there is returned as it is)."""
    if isinstance(x, torch.Tensor):
        return x if x.device == dev else x.to(dev)
    if isinstance(x, Calib):
        return x if x.device == dev else x.to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(tree_to(a, dev) for a in x))
    if isinstance(x, (tuple, list)):
        return type(x)(tree_to(a, dev) for a in x)
    return x


class Placed:
    """One value split or copied over a placer's local shards: `parts[k]`
    lives on the placer's k-th device."""

    __slots__ = ("parts", "placer")

    def __init__(self, parts, placer):
        self.parts = tuple(parts)
        self.placer = placer


class _OneShard:
    """The unsharded call: one shard on the value's own device; sums and
    gathers of one part are that part, untouched."""

    n_local = 1

    @staticmethod
    def reduce(parts):
        return parts[0]

    @staticmethod
    def gather_points(parts, dim: int = 0):
        return parts[0]

    @staticmethod
    def copies(x):
        return [x]


ONE = _OneShard()


def unplace(x):
    """(parts, placer) of a BA program's input: a Placed value's parts and
    placer, or a plain value as one shard."""
    if isinstance(x, Placed):
        return x.parts, x.placer
    return (x,), ONE


def parts_of(x, placer):
    """`x` as one part per local shard of `placer` (a plain value is
    copied to each shard's device)."""
    if isinstance(x, Placed):
        return x.parts
    return placer.copies(x)


class Placer:
    """Places the pipeline's point-axis programs on shards.

    FullSystem routes its BA and point-marginalization dispatches through
    one of these when Config.mesh_devices > 1 or under a multi-process
    group: inputs are placed (points and the [F, P] incidence split, the
    rest replicated), the SAME program runs over the shards, and gather()
    brings its results to the home device, where the rest of the window
    state lives.

    `mesh` is a Mesh, or an explicit list of local shard devices (which
    may repeat one device: one card or the CPU holding n shards). `home`
    defaults to the first local device. Under a process group (made by
    parallel/dist_init) camera-sized sums use all_reduce and per-point
    results all_gather; the ranks must then call the programs in the same
    order, which running the same host pipeline gives.
    """

    def __init__(self, mesh, home=None):
        self._group = _in_group()
        self.rank = dist.get_rank() if self._group else 0
        self.world = dist.get_world_size() if self._group else 1
        if not isinstance(mesh, Mesh):
            local = [_norm(d) for d in mesh]
            devs = np.empty(len(local) * self.world, dtype=object)
            devs[:] = local * self.world
            shape = (self.world, len(local)) if self._group \
                else _grid(len(local))
            mesh = Mesh(devs.reshape(shape), ("dp", "mp"))
        self.mesh = mesh
        if self._group:
            if mesh.devices.shape[0] != self.world:
                raise RuntimeError(
                    f"mesh rows {mesh.devices.shape[0]} != world size "
                    f"{self.world}")
            self.devices = list(mesh.devices[self.rank])
        else:
            self.devices = list(mesh.devices.reshape(-1))
        self.n_local = len(self.devices)
        self.n_shards = self.n_local * self.world
        self.home = _norm(home) if home is not None \
            else self.devices[0]
        self._img_key = None
        self._img_placed = None

    # -- layout ------------------------------------------------------------
    def _bounds(self, P: int):
        if P % self.n_shards:
            raise ValueError(f"point capacity {P} does not divide over "
                             f"{self.n_shards} shards")
        n = P // self.n_shards
        g0 = self.rank * self.n_local
        return [((g0 + k) * n, (g0 + k + 1) * n)
                for k in range(self.n_local)]

    def _split(self, x, dim: int):
        return [x.narrow(dim, lo, hi - lo).to(d).contiguous()
                for (lo, hi), d in zip(self._bounds(x.shape[dim]),
                                       self.devices)]

    # -- placement ---------------------------------------------------------
    def copies(self, tree):
        """`tree` on every local shard's device (one move per distinct
        device; on one device every part is `tree` itself)."""
        moved = {}
        out = []
        for d in self.devices:
            if d not in moved:
                moved[d] = tree_to(tree, d)
            out.append(moved[d])
        return out

    def replicate(self, tree):
        return Placed(self.copies(tree), self)

    def place_images(self, images):
        """Replicate the window's level-0 image stack, once per stack: the
        cache holds the tensor it was made from and compares by identity.
        That is safe because the window never writes its stack in place
        (window_ops._set clones, and insert_frame builds a new stack); an
        in-place write would leave a stale copy here."""
        if self._img_key is not images:
            self._img_placed = self.replicate(images)
            self._img_key = images
        return self._img_placed

    def point_sharded(self, x):
        """A [P, ...] tensor split along its first axis."""
        return Placed(self._split(x, 0), self)

    def pair_sharded(self, x):
        """An [F, P, ...] tensor split along the point axis."""
        return Placed(self._split(x, 1), self)

    def _points(self, pts):
        fields = [self._split(f, 0) for f in pts]
        return [type(pts)(*(f[k] for f in fields))
                for k in range(self.n_local)]

    def place_ba(self, problem):
        """A visual window problem: points and pair_mask split, the rest
        replicated."""
        rep = self.copies(problem._replace(points=None, pair_mask=None))
        pts = self._points(problem.points)
        pm = self._split(problem.pair_mask, 1)
        return Placed([r._replace(points=p, pair_mask=m)
                       for r, p, m in zip(rep, pts, pm)], self)

    def place_vio(self, problem):
        """An extended (visual + inertial) problem: the IMU block is frame
        sized and replicated; the point axis splits as in place_ba."""
        rep = self.copies(problem._replace(base=None))
        base = self.place_ba(problem.base).parts
        return Placed([r._replace(base=b) for r, b in zip(rep, base)], self)

    def gather(self, tree):
        """Bring a program's results to the home device. The programs
        return whole (gathered) results on the first shard's device."""
        return tree_to(tree, self.home)

    # -- collectives the programs use ---------------------------------------
    def reduce(self, parts):
        """Sum camera-sized partials: local shards in shard order on the
        first shard's device, then all_reduce across ranks."""
        d0 = self.devices[0]
        out = parts[0].to(d0)
        for p in parts[1:]:
            out = out + p.to(d0)
        if self._group:
            out = out.clone() if out is parts[0] else out
            dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out

    def gather_points(self, parts, dim: int = 0):
        """Concatenate per-point parts along `dim` in shard order on the
        first shard's device, then all_gather across ranks (bool travels as
        uint8: the collectives take no bool)."""
        d0 = self.devices[0]
        out = torch.cat([p.to(d0) for p in parts], dim)
        if not self._group:
            return out
        is_bool = out.dtype == torch.bool
        x = out.to(torch.uint8) if is_bool else out.contiguous()
        got = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(got, x)
        full = torch.cat(got, dim)
        return full.to(torch.bool) if is_bool else full


def shard_problem(problem, images, mesh: Mesh):
    """Place a BAProblem on `mesh`: points split, frames replicated."""
    placer = Placer(mesh)
    return placer.place_ba(problem), placer.place_images(images)


def optimize_dist(problem, images, mesh: Mesh, max_iters: int = 6):
    """Sharded windowed BA: the same program as ba.optimize, its point axis
    over `mesh`; the result (on the mesh's first device) equals the
    single-device one up to the order of the camera-system sums."""
    from dmvio_tpu_torch.models import ba

    return ba.optimize(*shard_problem(problem, images, mesh),
                       max_iters=max_iters)
