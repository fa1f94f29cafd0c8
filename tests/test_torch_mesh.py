"""The port's process mesh (elasticdl_tpu_torch/parallel/mesh.py) against
the JAX package's device mesh, on gloo ranks on the CPU.

A JAX mesh lays devices out as ``np.array(devices).reshape(dp, pp, ep,
tp, sp)``; the port's rank r must sit where the JAX mesh over devices
0..n-1 puts device r, and its group along an axis must hold the ranks of
that axis's line through it.  The ranks run in spawned processes (one
thread each, joined under a time limit); this module imports JAX only in
the test process, inside the tests.
"""

import numpy as np
import pytest
import torch

from elasticdl_tpu_torch.parallel import launch
from elasticdl_tpu_torch.parallel import mesh as tmesh

LAYOUTS = [dict(dp=None, sp=2), dict(dp=None, sp=4), dict(dp=4),
           dict(dp=2, sp=2)]


def rank_layouts(layouts):
    """In each rank: its coordinates and, per axis larger than 1, the
    global ranks of its group, for every layout."""
    import torch.distributed as dist

    out = []
    for kwargs in layouts:
        mesh = tmesh.build_mesh(**kwargs, backend="gloo", device="cpu")
        out.append({
            "shape": mesh.shape, "coords": mesh.coords,
            "groups": {a: dist.get_process_group_ranks(mesh.group(a))
                       for a in tmesh.AXES if mesh.shape[a] > 1},
            "world": dist.get_process_group_ranks(mesh.group()),
            "device": str(mesh.device)})
    with pytest.raises(NotImplementedError, match="A18"):
        tmesh.build_mesh(dp=2, tp=2, backend="gloo", device="cpu")
    with pytest.raises(ValueError, match="ranks"):
        tmesh.build_mesh(dp=3, sp=2, backend="gloo", device="cpu")
    return out


@pytest.fixture(scope="module")
def ranks():
    return launch.spawn(rank_layouts, 4, (LAYOUTS,), threads=1, timeout=120)


@pytest.mark.parametrize("layout", range(len(LAYOUTS)))
def test_rank_coordinates_follow_the_jax_layout(ranks, layout):
    import jax

    from elasticdl_tpu.parallel.mesh import build_mesh

    kwargs = LAYOUTS[layout]
    jmesh = build_mesh(**kwargs, devices=jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for rank, seen in enumerate(ranks):
        got = seen[layout]
        assert got["shape"] == dict(jmesh.shape)
        assert got["device"] == "cpu"
        where = tuple(int(i) for i in np.argwhere(ids == rank)[0])
        assert tuple(got["coords"][a] for a in tmesh.AXES) == where
        for i, axis in enumerate(tmesh.AXES):
            if jmesh.shape[axis] == 1:
                continue
            line = np.moveaxis(ids, i, -1)[
                tuple(c for j, c in enumerate(where) if j != i)]
            assert got["groups"][axis] == [int(r) for r in line]
        assert got["world"] == [0, 1, 2, 3]


def test_factor_mesh_and_errors_match_jax():
    from elasticdl_tpu.parallel.mesh import factor_mesh

    for n in range(1, 17):
        for tp in (True, False):
            for sp in (True, False):
                assert tmesh.factor_mesh(n, tp, sp) == factor_mesh(n, tp, sp)
    assert tmesh.AXES == ("dp", "pp", "ep", "tp", "sp")
    # Without an initialised world there is no mesh to build.
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.build_mesh(sp=2, backend="gloo", device="cpu")
