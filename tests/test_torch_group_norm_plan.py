"""The GroupNorm kernels' launch plan (``ops/group_norm.py`` ``plan``),
held on the CPU: it is a pure function of the shape.

For every GroupNorm shape of ResNet-50 at 224x224 (the served batch 4,
the kernel table's 32 and bench.py's 128, float32 and bfloat16, forward
and backward) the plan must fit the 227 KB of shared memory a block may
use, give every block of a cluster at least one row, and lay out buffers
that hold every index the CUDA kernels compute (the index arithmetic of
``csrc/group_norm.cu`` and ``csrc/group_norm_bwd.cu`` is repeated here);
the backward's workspace must hold the per-(batch, channel) sums the
kernel writes.  The edge plans of the ``cuda`` tests are held too.
"""

import pytest

from elasticdl_tpu_torch.ops import group_norm as gn

GROUPS = 32
# ResNet-50 at 224x224: (HW, C) of its 53 GroupNorm calls.
RESNET50 = [(112 * 112, 64), (56 * 56, 64), (56 * 56, 128), (56 * 56, 256),
            (28 * 28, 128), (28 * 28, 256), (28 * 28, 512), (14 * 14, 256),
            (14 * 14, 512), (14 * 14, 1024), (7 * 7, 512), (7 * 7, 2048)]
ESIZE = {"float32": 4, "bfloat16": 2}


def _layout_ok(B, HW, C, G, esize, backward, p):
    """Repeat the kernels' index arithmetic for plan ``p`` and check
    every buffer's largest index against the layout they share."""
    K, R, rr = p.cluster, p.rows, p.resident
    assert 1 <= K <= gn.MAX_CLUSTER
    assert (K - 1) * R < HW <= K * R, "a block of the cluster has no row"
    assert 0 <= rr <= R and 0 <= p.pieces <= gn.MAX_PIECES
    assert (rr > 0) == (p.pieces > 0) and p.pieces <= rr
    assert p.smem <= gn.SMEM_MAX
    if not p.vec:
        assert rr == 0, "the bulk copy needs 16-byte rows"
    V = 16 // esize if p.vec else 1
    assert C % V == 0
    nv = C // V
    tc = min(nv, gn.THREADS)
    lanes = gn.THREADS // tc
    cpg = C // G
    # Resident rows of x (and dy) from byte 0, 16-byte rows when vec.
    data = rr * C * esize * (2 if backward else 1)
    if rr:
        assert (C * esize) % 16 == 0
    floats = lanes * C * 2                       # red1, red2 [lanes][C]
    if backward:
        own = -(-G // K) * cpg
        for k in range(K):
            g0, g1 = k * G // K, (k + 1) * G // K
            assert (g1 - g0) * cpg <= own
        for c in range(C):
            g = c // cpg
            owner = ((g + 1) * K - 1) // G
            assert owner * G // K <= g < (owner + 1) * G // K
            j = c - owner * G // K * cpg
            assert 0 <= j < own
        recv = 2 * K * own
        assert (K + K - 1) * own + own - 1 < recv
        floats += recv + 2 * G                   # recv, gall
        assert 2 * (G - 1) + 1 < 2 * G
        # csum[b C + c] and csum[(B + b) C + c]
        assert (B + B - 1) * C + C - 1 < p.workspace
    else:
        # parts[parity][k][g][3], parity the batch row's
        assert 3 * K * G + ((K - 1) * G + G - 1) * 3 + 2 < 6 * K * G
        floats += G + 6 * K * G + 2 * G          # shift, parts, gstat
        assert p.workspace == 0
    bars = p.smem - 8 * p.pieces
    assert data + floats * 4 <= bars and bars % 8 == 0
    assert p.smem == gn._smem_bytes(C, G, K, rr, p.pieces, esize, V,
                                    backward)


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [4, 32, 128])
@pytest.mark.parametrize("HW,C", RESNET50,
                         ids=["%dx%d" % s for s in RESNET50])
def test_resnet50_plans_fit(HW, C, batch, dtype, backward):
    esize = ESIZE[dtype]
    p = gn.plan(batch, HW, C, GROUPS, esize, backward)
    _layout_ok(batch, HW, C, GROUPS, esize, backward, p)
    assert p.vec == 1
    assert p == gn.plan(batch, HW, C, GROUPS, esize, backward)
    # The design's claim: a bfloat16 row is held on chip at every shape,
    # and a float32 one in the forward.
    if dtype == "bfloat16" or not backward:
        assert p.resident == p.rows, p


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("B,HW,C,G,esize,aligned", [
    (2, 50, 12, 4, 4, True),        # C not a multiple of 4 floats
    (2, 50, 12, 4, 2, True),        # nor of 8 bf16
    (2, 36, 8, 4, 2, False),        # a view 8 bytes off 16
    (1, 112 * 112, 64, 32, 4, True),  # B = 1, the float32 stem
    (3, 5, 384, 32, 2, True),       # HW under one block's rows
    (2, 1, 64, 32, 4, True),        # one row
    (2, 9, 3 * 640, 32, 4, True),   # C / V over one block of threads
])
def test_edge_plans(B, HW, C, G, esize, aligned, backward):
    p = gn.plan(B, HW, C, G, esize, backward, aligned=aligned)
    _layout_ok(B, HW, C, G, esize, backward, p)
    assert p.vec == int(aligned and (C * esize) % 16 == 0)


def test_ablation_knobs_keep_plans_valid():
    for HW, C in RESNET50:
        for backward in (False, True):
            for kw in ({"smem_budget": 0}, {"max_cluster": 8},
                       {"target_blocks": 1}, {"smem_budget": 116 * 1024},
                       {"piece_bytes": 1 << 30}, {"piece_bytes": 1}):
                p = gn.plan(32, HW, C, GROUPS, 2, backward, **kw)
                _layout_ok(32, HW, C, GROUPS, 2, backward, p)
                if kw.get("smem_budget") == 0:
                    assert p.resident == 0
                if "max_cluster" in kw:
                    assert p.cluster <= 8
