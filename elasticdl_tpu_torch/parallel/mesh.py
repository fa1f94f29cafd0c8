"""Process meshes for data and sequence parallelism (counterpart of
``elasticdl_tpu/parallel/mesh.py``).

The JAX mesh is one program's view of many devices: axes (dp, pp, ep,
tp, sp) over an array of devices, and XLA inserts the collectives.  Here
every rank is a process of an initialised ``torch.distributed`` world,
and the mesh is that rank's view of the grid: its coordinates, and one
process group per axis holding the ranks that differ from it along that
axis only.  Ranks take grid coordinates in the order of
``np.arange(world).reshape(dp, pp, ep, tp, sp)``, as the JAX mesh lays
out ``np.array(devices).reshape(dp, pp, ep, tp, sp)``.

The groups' backend is the caller's choice, passed explicitly: ``nccl``
for ranks on cards of their own, ``gloo`` for ranks that share one card
(NCCL refuses two ranks on one device) and for the CPU; ``transport``
stages CUDA tensors through the host on a gloo group.  A rank's device is
``cuda:(rank % device_count)`` unless the caller passes ``"cpu"``.

Only ``dp`` and ``sp`` are ported: meshes with ``pp``, ``tp`` or ``ep``
larger than 1 (tensor, pipeline and expert parallelism) raise
``NotImplementedError`` naming ROADMAP A18.
"""

import numpy as np
import torch
import torch.distributed as dist

from elasticdl_tpu_torch.utils.device import resolve_device

AXES = ("dp", "pp", "ep", "tp", "sp")


class Mesh:
    """One rank's view of the grid.  ``shape`` maps each axis to its size
    (the JAX ``mesh.shape``), ``coords`` to this rank's index along it;
    ``group(axis)`` is the process group along an axis larger than 1 and
    ``group()`` the whole mesh's."""

    def __init__(self, shape, coords, groups, world_group, device):
        self.shape = shape
        self.coords = coords
        self._groups = groups
        self._world_group = world_group
        self.device = device

    def group(self, axis=None):
        return self._world_group if axis is None else self._groups[axis]


def _check_ported(shape):
    unported = {a: n for a, n in shape.items() if a in ("pp", "ep", "tp")
                and n > 1}
    if unported:
        raise NotImplementedError(
            "mesh axes %s are not ported yet (ROADMAP A18: tensor, pipeline "
            "and expert parallelism); dp and sp are" % unported)


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
    _check_ported(shape)
    rank = dist.get_rank()
    grid = np.arange(n).reshape(tuple(shape.values()))
    coords = dict(zip(AXES, (int(i) for i in
                             np.unravel_index(rank, grid.shape))))
    groups = {}
    for i, axis in enumerate(AXES):
        if shape[axis] == 1:
            continue
        # Every line of the grid along this axis, in one fixed order.
        lines = np.moveaxis(grid, i, -1).reshape(-1, shape[axis])
        for line in lines:
            group = dist.new_group([int(r) for r in line], backend=backend,
                                   timeout=timeout)
            if rank in line:
                groups[axis] = group
    world_group = dist.new_group(list(range(n)), backend=backend,
                                 timeout=timeout)
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
