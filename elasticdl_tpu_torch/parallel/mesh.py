"""Process meshes for data, pipeline, expert, tensor and sequence
parallelism (counterpart of ``elasticdl_tpu/parallel/mesh.py``).

The JAX mesh is one program's view of many devices: axes (dp, pp, ep,
tp, sp) over an array of devices, and XLA inserts the collectives.  Here
every rank is a process of an initialised ``torch.distributed`` world,
and the mesh is that rank's view of the grid: its coordinates, one
process group per axis holding the ranks that differ from it along that
axis only, and one group per set of axes (the ranks that differ from it
along those axes only): a gradient is summed over the axes its
parameter's spec does not name, and MoE router statistics over ``dp``
and ``sp`` together.  Ranks take grid coordinates in the order of
``np.arange(world).reshape(dp, pp, ep, tp, sp)``, as the JAX mesh lays
out ``np.array(devices).reshape(dp, pp, ep, tp, sp)``.

The groups' backend is the caller's choice, passed explicitly: ``nccl``
for ranks on cards of their own, ``gloo`` for ranks that share one card
(NCCL refuses two ranks on one device) and for the CPU; ``transport``
stages CUDA tensors through the host on a gloo group.  A rank's device is
``cuda:(rank % device_count)`` unless the caller passes ``"cpu"``.

"""

import contextlib
import itertools
import threading

import numpy as np
import torch
import torch.distributed as dist

from elasticdl_tpu_torch.utils.device import resolve_device

AXES = ("dp", "pp", "ep", "tp", "sp")


class Mesh:
    """One rank's view of the grid.  ``shape`` maps each axis to its size
    (the JAX ``mesh.shape``), ``coords`` to this rank's index along it;
    ``group(axis)`` is the process group along an axis larger than 1,
    ``group((a, b, ...))`` the group along several (its ranks in the order
    of ``np.arange(world).reshape(...)`` over those axes, in ``AXES``
    order; None where every one of them is 1) and ``group()`` the whole
    mesh's."""

    def __init__(self, shape, coords, groups, world_group, device):
        self.shape = shape
        self.coords = coords
        self._groups = groups
        self._world_group = world_group
        self.device = device

    def live(self, axes):
        """The axes of ``axes`` (a name or names) larger than 1, in
        ``AXES`` order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in AXES if a in axes and self.shape[a] > 1)

    def size(self, axes):
        return int(np.prod([self.shape[a] for a in self.live(axes)]))

    def group(self, axis=None):
        if axis is None:
            return self._world_group
        if isinstance(axis, str):
            return self._groups[axis]
        live = self.live(axis)
        return self._groups.get(live) if live else None

    def flat(self):
        """The whole mesh as one data axis: ``dp`` spans every rank (its
        group the world's), the other axes are 1.  Ranks keep their
        order, the grid's."""
        sizes = [self.shape[a] for a in AXES]
        shape = dict.fromkeys(AXES, 1)
        coords = dict.fromkeys(AXES, 0)
        shape["dp"] = int(np.prod(sizes))
        coords["dp"] = int(np.ravel_multi_index(
            [self.coords[a] for a in AXES], sizes))
        groups = ({"dp": self._world_group, ("dp",): self._world_group}
                  if shape["dp"] > 1 else {})
        return Mesh(shape, coords, groups, self._world_group, self.device)


_split = threading.local()


@contextlib.contextmanager
def batch_split(mesh):
    """Forwards run on this thread inside the block take their batch as
    one rank's rows of a global batch split over ``mesh`` (a mesh of
    ``dp`` alone, or None), where their spec has no mesh of its own:
    the collective trainer's world, ``Mesh.flat()``.  A model whose
    forward takes statistics over the batch (the MoE router's) sums them
    over it."""
    before = getattr(_split, "mesh", None)
    _split.mesh = mesh
    try:
        yield
    finally:
        _split.mesh = before


def batch_split_mesh():
    """The mesh of the innermost ``batch_split`` on this thread, or
    None."""
    return getattr(_split, "mesh", None)


def build_mesh(dp=None, pp=1, tp=1, sp=1, ep=1, *, backend, device=None,
               timeout=None):
    """The mesh with axes (dp, pp, ep, tp, sp) over the initialised
    ``torch.distributed`` world; ``dp=None`` means whatever is left after
    pp*ep*tp*sp.  Every rank must call it, in the same order as its other
    group creations: each axis's groups are made by all ranks together.
    ``backend`` names the groups' backend; ``device`` is this rank's
    (``None``: ``cuda:(rank % device_count)``); ``timeout`` (a
    ``timedelta``) bounds the groups' collectives (None: torch's default
    for the backend, not the world's)."""
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs an initialised torch.distributed "
                           "world (init_process_group)")
    n = dist.get_world_size()
    fixed = pp * ep * tp * sp
    if dp is None:
        if n % fixed:
            raise ValueError(
                "%d ranks not divisible by pp*ep*tp*sp=%d" % (n, fixed))
        dp = n // fixed
    if dp * fixed != n:
        raise ValueError("dp*pp*ep*tp*sp=%d != %d ranks" % (dp * fixed, n))
    shape = dict(zip(AXES, (dp, pp, ep, tp, sp)))
    rank = dist.get_rank()
    grid = np.arange(n).reshape(tuple(shape.values()))
    coords = dict(zip(AXES, (int(i) for i in
                             np.unravel_index(rank, grid.shape))))
    world_group = dist.new_group(list(range(n)), backend=backend,
                                 timeout=timeout)
    live = [i for i, a in enumerate(AXES) if shape[a] > 1]
    groups = {}
    # Every set of live axes, one axis first, then pairs, ...; for each,
    # every block of the grid along those axes, in one fixed order.
    for k in range(1, len(live) + 1):
        for dims in itertools.combinations(live, k):
            key = tuple(AXES[i] for i in dims)
            if k == len(live):
                groups[key] = world_group
                continue
            size = int(np.prod([shape[AXES[i]] for i in dims]))
            blocks = np.moveaxis(grid, dims, range(-k, 0)).reshape(-1, size)
            for block in blocks:
                group = dist.new_group([int(r) for r in block],
                                       backend=backend, timeout=timeout)
                if rank in block:
                    groups[key] = group
    for key in list(groups):
        if len(key) == 1:
            groups[key[0]] = groups[key]
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    return Mesh(shape, coords, groups, world_group, device)


def data_mesh(*, backend, device=None, timeout=None):
    """Pure data-parallel mesh (the elastic AllReduce replacement)."""
    return build_mesh(dp=None, backend=backend, device=device,
                      timeout=timeout)


def factor_mesh(n, want_tp=True, want_sp=True):
    """Heuristic axis sizing for n ranks: give tp/sp a factor of 2 each
    when available, the rest to dp (the JAX ``factor_mesh``)."""
    tp = 2 if want_tp and n % 2 == 0 else 1
    rem = n // tp
    sp = 2 if want_sp and rem % 2 == 0 else 1
    dp = rem // sp
    return dict(dp=dp, pp=1, tp=tp, sp=sp)
