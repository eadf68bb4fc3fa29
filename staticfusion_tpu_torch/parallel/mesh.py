"""Device mesh and sharding layout (port of
staticfusion_tpu/parallel/mesh.py) over torch.distributed.

Two mesh axes, as in the JAX package:

* `pix`  — image rows: the per-pixel stages with no neighbourhood (the
  solver's Jacobian rows, the segmentation image, the temporal residual's
  per-pixel terms) run on the rank's row block; stencils and gathers run
  on full images, all-gathered over `pix`.
* `map`  — surfel slots: every per-surfel pass runs on the rank's block of
  slots; the z-buffer scatter-mins combine with a MIN all-reduce over
  `map`, and the rows of winning surfels with a SUM all-reduce (the owner
  writes, every other rank writes zeros).

One rank drives one device.  Rank r sits at (pix, map) = divmod(r, n_map),
the row-major order of the JAX mesh's device grid.  Every group is a
`ProcessGroupGloo` built from a store: the same code serves ranks that are
threads of one process (a `HashStore`) and ranks that are processes (a
`FileStore` or `TCPStore`); no default process group is created.

A placement is a tuple with one entry per dimension: the axis name the
dimension is divided over, or None; () is replicated (JAX's PartitionSpec
as a plain tuple).  Slot blocks divide the capacity evenly; row blocks may
differ by one row (rank i of n holds rows [R i // n, R (i+1) // n)).
"""

from __future__ import annotations

from datetime import timedelta

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}
# The (operation, dtype) pairs that ProcessGroupGloo runs on CUDA tensors
# itself (through pinned host buffers): all of the helpers' on float32 and
# int64, as chip_smoke.py's parallel phase probes them on the H100 (torch
# 2.11).  A CUDA tensor of any other pair is staged through a host copy.
GLOO_CUDA = frozenset((op, dt) for op in ("sum", "min", "max", "gather")
                      for dt in (torch.float32, torch.int64))


def _wire(x: torch.Tensor, op: str) -> torch.Tensor:
    """A contiguous copy of x where Gloo will run `op` on it: on its device
    when Gloo takes the pair there, else on the host."""
    if x.device.type == "cpu" or (op, x.dtype) in GLOO_CUDA:
        return x.detach().clone(memory_format=torch.contiguous_format)
    return x.detach().to("cpu").contiguous()


def block(n: int, parts: int, i: int) -> tuple:
    """[lo, hi) of block i when n items split into `parts` row blocks."""
    return n * i // parts, n * (i + 1) // parts


class Mesh:
    """This rank's place in an (n_pix, n_map) mesh, its groups, and
    counters: `comm[helper] = [calls, bytes sent]` per collective helper,
    `work[(stage, full extent)] = items this rank processed` per divided
    stage (slots for per-surfel passes, pixels for per-pixel ones)."""

    def __init__(self, rank: int, n_pix: int, n_map: int, world, pix_group,
                 map_group, device):
        self.rank, self.n_pix, self.n_map = rank, n_pix, n_map
        self.pix, self.map = divmod(rank, n_map)
        self.groups = {"world": world, "pix": pix_group, "map": map_group}
        self.device = torch.device(device)
        self.comm: dict = {}
        self.work: dict = {}

    def axis_size(self, axis: str) -> int:
        return {"world": self.n_pix * self.n_map, "pix": self.n_pix,
                "map": self.n_map}[axis]

    def axis_index(self, axis: str) -> int:
        return {"world": self.rank, "pix": self.pix, "map": self.map}[axis]

    def rows(self, n: int) -> tuple:
        """[lo, hi) of this rank's block of n image rows."""
        return block(n, self.n_pix, self.pix)

    def slots(self, capacity: int) -> tuple:
        """[lo, hi) of this rank's block of a `capacity`-slot map."""
        if capacity % self.n_map:
            raise ValueError(f"map capacity {capacity} does not divide over "
                             f"{self.n_map} map ranks")
        return block(capacity, self.n_map, self.map)

    def note(self, stage: str, extent, n: int) -> None:
        """Record that `stage` processed n items of a full `extent`."""
        self.work[(stage, extent)] = int(n)

    def _count(self, name: str, x: torch.Tensor) -> None:
        c = self.comm.setdefault(name, [0, 0])
        c[0] += 1
        c[1] += x.numel() * x.element_size()

    def all_reduce(self, x: torch.Tensor, op: str, axis: str) -> torch.Tensor:
        """`op` ("sum", "min", "max") of x over `axis`; a new tensor."""
        pg = self.groups[axis]
        if pg is None:
            return x
        self._count(f"all_reduce_{op}", x)
        buf = _wire(x, op)
        opts = dist.AllreduceOptions()
        opts.reduceOp = _OPS[op]
        pg.allreduce([buf], opts).wait()
        return buf.to(x.device)

    def all_gather(self, x: torch.Tensor, axis: str, n: int,
                   dim: int = 0) -> torch.Tensor:
        """The row blocks of a dimension of full extent n, concatenated
        along `dim` in axis order (blocks as `block` splits them)."""
        pg = self.groups[axis]
        if pg is None:
            return x
        self._count("all_gather", x)
        parts = self.axis_size(axis)
        sizes = [block(n, parts, i)[1] - block(n, parts, i)[0]
                 for i in range(parts)]
        assert x.shape[dim] == sizes[self.axis_index(axis)], (x.shape, sizes)
        buf = _wire(x.movedim(dim, 0), "gather")
        width = max(sizes)
        if buf.shape[0] < width:
            buf = torch.cat([buf, buf.new_zeros((width - buf.shape[0],)
                                                + buf.shape[1:])])
        outs = [torch.empty_like(buf) for _ in range(parts)]
        pg.allgather([outs], [buf]).wait()
        full = torch.cat([o[:s] for o, s in zip(outs, sizes)])
        return full.movedim(0, dim).to(x.device)


def make_mesh(n_pix: int, n_map: int, rank: int, store,
              timeout: timedelta = timedelta(seconds=60),
              device="cuda", hostname: str | None = "127.0.0.1") -> Mesh:
    """This rank's Mesh: world, pix and map groups, each a
    ProcessGroupGloo over its own PrefixStore of `store` (groups of one
    rank are None).  Every rank of the mesh must call it, in any order.
    `hostname` is the address Gloo binds (None: the host's default
    interface, for ranks on several hosts)."""
    n = n_pix * n_map
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} outside a {n_pix}x{n_map} mesh")

    def group(name, members):
        if len(members) == 1:
            return None
        opts = dist.ProcessGroupGloo._Options()
        opts._timeout = timeout
        opts._devices = [
            dist.ProcessGroupGloo.create_default_device() if hostname is None
            else dist.ProcessGroupGloo.create_device(hostname=hostname)]
        return dist.ProcessGroupGloo(dist.PrefixStore(name, store),
                                     members.index(rank), len(members), opts)

    p, m = divmod(rank, n_map)
    world = group("world", list(range(n)))
    pix_group = group(f"pix{m}", [q * n_map + m for q in range(n_pix)])
    map_group = group(f"map{p}", [p * n_map + q for q in range(n_map)])
    return Mesh(rank, n_pix, n_map, world, pix_group, map_group, device)


# -- the placement trees (JAX mesh.py:40-70) ------------------------------

def surfel_map_shardings():
    """Every per-surfel array along its slot axis over `map`; `used`
    replicated."""
    from staticfusion_tpu_torch.fusion.surfels import SurfelMap
    s1, s2 = ("map",), ("map", None)
    return SurfelMap(pos=s2, conf=s1, color=s2, hist=s1, init_time=s1,
                     last_time=s1, normal=s2, radius=s1, valid=s1, used=())


def state_shardings():
    """SlamState-shaped tree: surfels over `map`, image rows over `pix`
    (the rings along dim 1), small state replicated."""
    from staticfusion_tpu_torch.fusion.predict import PredictedView
    from staticfusion_tpu_torch.pipeline.state import RingBuffers, SlamState
    rep, rows2, rows3 = (), ("pix", None), ("pix", None, None)
    ring = (None, "pix", None)
    return SlamState(
        smap=surfel_map_shardings(), curr_pose=rep, tick=rep, im_count=rep,
        twist_old=rep, rings=RingBuffers(depth=ring, intensity=ring,
                                         odom=rep),
        prev_rgb=rows3, prev_filt_depth=rows2, prev_static_prob=rows2,
        per_cluster_residual=rep,
        pred=PredictedView(image=rows3, vertex=rows3, conf=rows2,
                           normal=rows3, radius=rows2, time=rows2,
                           depth=rows2))


def frame_shardings():
    from staticfusion_tpu_torch.pipeline.step import Frame
    return Frame(rgb=("pix", None, None), depth_mm=("pix", None))


def map_tree(fn, tree, specs):
    """fn(leaf, placement) over a tree of NamedTuples and its placement
    tree."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[map_tree(fn, t, s)
                            for t, s in zip(tree, specs)])
    return fn(tree, specs)


def shard_tree(tree, specs, mesh: Mesh):
    """Each leaf cut to this rank's block along every divided
    dimension."""
    def cut(x, spec):
        for dim, axis in enumerate(spec):
            if axis == "map":
                lo, hi = mesh.slots(x.shape[dim])
            elif axis == "pix":
                lo, hi = mesh.rows(x.shape[dim])
            else:
                continue
            x = x.narrow(dim, lo, hi - lo)
        return x.to(mesh.device).contiguous()
    return map_tree(cut, tree, specs)


def gather_tree(tree, specs, mesh: Mesh, rows: int):
    """The full leaves back from the blocks of every rank: all-gathers
    over `map` (even blocks) and over `pix` (blocks of `rows` rows)."""
    def join(x, spec):
        for dim, axis in enumerate(spec):
            if axis is not None:
                n = (x.shape[dim] * mesh.n_map if axis == "map" else rows)
                x = mesh.all_gather(x, axis, n, dim)
        return x
    return map_tree(join, tree, specs)


def place_state(state, mesh: Mesh):
    """A host-local (full) SlamState cut to this rank's blocks."""
    return shard_tree(state, state_shardings(), mesh)


# -- the helpers the step, solver and fuse take a mesh through ------------

def local_rows(x: torch.Tensor, mesh: Mesh | None, dim: int = 0):
    """This rank's row block of x (x itself without a mesh)."""
    if mesh is None:
        return x
    lo, hi = mesh.rows(x.shape[dim])
    return x.narrow(dim, lo, hi - lo)


def gather_rows(x: torch.Tensor, mesh: Mesh | None, rows: int,
                dim: int = 0):
    """The full image of `rows` rows from every rank's row block (x itself
    without a mesh)."""
    if mesh is None:
        return x
    return mesh.all_gather(x, "pix", rows, dim)


def map_sum(x: torch.Tensor, mesh: Mesh | None):
    """SUM of a per-block quantity over `map` (x itself without a
    mesh)."""
    return x if mesh is None else mesh.all_reduce(x, "sum", "map")


def slot_base(capacity: int, mesh: Mesh | None) -> tuple:
    """(global capacity, first global slot) of a map block of `capacity`
    slots: (capacity, 0) without a mesh."""
    if mesh is None:
        return capacity, 0
    full = capacity * mesh.n_map
    return full, mesh.slots(full)[0]


def gather_images(images, mesh: Mesh | None, rows: int) -> tuple:
    """Whole float32 images ((rows, W) or (rows, W, C)) from every rank's
    row blocks, in one all-gather over `pix` (the images themselves
    without a mesh)."""
    images = tuple(images)
    if mesh is None or mesh.n_pix == 1:
        return images
    h, w = images[0].shape[:2]
    chans = [1 if a.dim() == 2 else a.shape[2] for a in images]
    packed = torch.cat([a.reshape(h, w, c) for a, c in zip(images, chans)],
                       dim=2)
    whole = mesh.all_gather(packed, "pix", rows)
    out, c0 = [], 0
    for a, c in zip(images, chans):
        part = whole[:, :, c0:c0 + c]
        out.append(part[:, :, 0].contiguous() if a.dim() == 2
                   else part.contiguous())
        c0 += c
    return tuple(out)
