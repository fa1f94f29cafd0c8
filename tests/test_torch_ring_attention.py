"""The port's sequence-parallel attention (``ring_attention`` over a mesh,
``ulysses_attention``; elasticdl_tpu_torch/parallel/) against the JAX
package's on the same mesh shape, on the CPU.

The port's ranks are spawned processes on a gloo group (one thread each,
joined under a time limit), each holding its shard [B/dp, T/sp, H, D];
the JAX functions run on the whole arrays over a mesh of virtual CPU
devices, as the JAX package's own tests run them: the ring with
``ELASTICDL_FLASH=interpret``, so its block step is the Pallas kernel B3p
in interpret mode, and Ulysses with the jnp attention (``off``, as
tests/test_ulysses.py runs it; the JAX Ulysses fails under interpret mode
on this JAX, whose shard_map checks the Pallas output's varying axes).  Inputs
and the output cotangent are made with numpy from a seed; each rank's
output and its shards' gradients (dq, and dk, dv after the ring has
carried them back) are held against the JAX arrays' blocks.  Tolerances
are the reference tests' own: 2e-5 abs/rel forward, 1e-4 gradients.
This module imports JAX only in the test process, inside the tests.
"""

import numpy as np
import pytest
import torch

from elasticdl_tpu_torch.parallel import launch

FWD_TOL = 2e-5
GRAD_TOL = 1e-4
H, D = 4, 64

# name: (dp, sp, T, B); each runs its cases in one spawned world.
WORLDS = {"sp2": (1, 2, 512, 1), "sp4": (1, 4, 512, 1),
          "dp2_sp2": (2, 2, 256, 2)}
# (world, impl, causal, window, kv heads): sp=2 shards of
# 256 keys take the stats backward and, with window 300, the banded
# block's two-block loop; sp=4 shards of 128 skip, run non-causal and
# band (window 200).
CASES = [
    ("sp2", "ring", True, 0, H),
    ("sp2", "ring", False, 0, H),
    ("sp2", "ring", True, 300, H),
    ("sp2", "ring", True, 0, 2),
    ("sp2", "ulysses", True, 0, H),
    ("sp2", "ulysses", True, 100, 2),
    ("sp4", "ring", True, 0, H),
    ("sp4", "ring", True, 200, H),
    ("sp4", "ring", False, 0, H),
    ("sp4", "ulysses", True, 0, H),
    ("dp2_sp2", "ring", True, 0, 2),
    ("dp2_sp2", "ulysses", False, 0, H),
]


def inputs(b, t, kv_heads, seed):
    rng = np.random.RandomState(seed)
    q, g = (rng.randn(b, t, H, D).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, t, kv_heads, D).astype(np.float32)
            for _ in range(2))
    return q, k, v, g


def expand(x, heads):
    """GQA: each K/V head serves heads / G consecutive query heads."""
    return x.repeat_interleave(heads // x.shape[2], dim=2)


def rank_cases(dp, sp, t, b, cases):
    """In each rank: (coords, per case its output shard and the gradients
    of its q, k, v shards)."""
    from elasticdl_tpu_torch.parallel.mesh import build_mesh
    from elasticdl_tpu_torch.parallel.ring_attention import ring_attention
    from elasticdl_tpu_torch.parallel.ulysses import ulysses_attention

    mesh = build_mesh(dp=dp, sp=sp, backend="gloo", device="cpu")
    bl, tl = b // dp, t // sp
    d, s = mesh.coords["dp"], mesh.coords["sp"]
    fns = {"ring": ring_attention, "ulysses": ulysses_attention}
    out = []
    for i, (_, impl, causal, window, kv_heads) in enumerate(cases):
        arrs = [torch.from_numpy(a[d * bl:(d + 1) * bl, s * tl:(s + 1) * tl]
                                 .copy()) for a in inputs(b, t, kv_heads, i)]
        q, k, v = (a.requires_grad_() for a in arrs[:3])
        o = fns[impl](q, expand(k, H), expand(v, H), mesh, causal=causal,
                      window=window)
        (o * arrs[3]).sum().backward()
        out.append([x.detach().numpy() for x in (o, q.grad, k.grad,
                                                  v.grad)])
    return mesh.coords, out


@pytest.fixture(scope="module")
def worlds():
    results = {}
    for name, (dp, sp, t, b) in WORLDS.items():
        cases = [c for c in CASES if c[0] == name]
        results[name] = launch.spawn(rank_cases, dp * sp,
                                     (dp, sp, t, b, cases), threads=1,
                                     timeout=240)
    return results


def jax_reference(name, impl, causal, window, kv_heads, seed):
    import jax
    import jax.numpy as jnp

    from elasticdl_tpu.parallel.mesh import build_mesh
    from elasticdl_tpu.parallel.ring_attention import ring_attention
    from elasticdl_tpu.parallel.ulysses import ulysses_attention

    dp, sp, t, b = WORLDS[name]
    mesh = build_mesh(dp=dp, sp=sp, devices=jax.devices()[:dp * sp])
    q, k, v, g = (jnp.asarray(a) for a in inputs(b, t, kv_heads, seed))
    fn = {"ring": ring_attention, "ulysses": ulysses_attention}[impl]

    def attend(q, k, v):
        rep = H // kv_heads
        return fn(q, jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2),
                  mesh, causal=causal, window=window)

    @jax.jit
    def forward_and_grads(q, k, v, g):
        o, vjp = jax.vjp(attend, q, k, v)
        return (o,) + vjp(g)

    return [np.asarray(x) for x in forward_and_grads(q, k, v, g)]


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=["-".join(map(str, c)) for c in CASES])
def test_matches_jax_on_the_same_mesh(worlds, case, monkeypatch):
    name, impl, causal, window, kv_heads = CASES[case]
    monkeypatch.setenv("ELASTICDL_FLASH",
                       "interpret" if impl == "ring" else "off")
    dp, sp, t, b = WORLDS[name]
    index = [c for c in CASES if c[0] == name].index(CASES[case])
    want = jax_reference(name, impl, causal, window, kv_heads, index)
    bl, tl = b // dp, t // sp
    for coords, results in worlds[name]:
        d, s = coords["dp"], coords["sp"]
        rows = (slice(d * bl, (d + 1) * bl), slice(s * tl, (s + 1) * tl))
        for part, got, ref, tol in zip(
                ("out", "dq", "dk", "dv"), results[index], want,
                (FWD_TOL, GRAD_TOL, GRAD_TOL, GRAD_TOL)):
            np.testing.assert_allclose(got, ref[rows], atol=tol, rtol=tol,
                                       err_msg="%s rank %s" % (part, coords))


def test_ulysses_needs_heads_divisible_by_sp():
    import types

    from elasticdl_tpu_torch.parallel import ring_attention as tring
    from elasticdl_tpu_torch.parallel.ulysses import ulysses_attention

    q, k, v = (torch.from_numpy(a) for a in inputs(1, 64, H, 0)[:3])
    mesh = types.SimpleNamespace(shape={"sp": 3})
    with pytest.raises(ValueError, match="heads % sp"):
        ulysses_attention(q, k, v, mesh)
    # sp 1 (or no mesh) is attention_local, with the window.
    one = types.SimpleNamespace(shape={"sp": 1})
    np.testing.assert_array_equal(
        ulysses_attention(q, k, v, one, window=16).numpy(),
        tring.attention_local(q, k, v, window=16).numpy())
