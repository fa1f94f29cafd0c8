"""The port's flash attention (elasticdl_tpu_torch/ops/flash_attention.py)
against the JAX package's, on the CPU, where the port's wrapper takes its
plain version and the JAX kernel runs in Pallas interpret mode.

Inputs are made with numpy from a seed and fed to both packages.
Tolerance 2e-5 abs/rel in float32, the JAX oracle's own
(tests/test_flash_attention.py): the two sides sum in other orders.  In
bfloat16 2e-2: both round p to bf16 before the p v product, the JAX
kernel against its running row max, the plain version against the final
one, so outputs may sit one bf16 rounding of p and one of out apart.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.ops import flash_attention as jfa
from elasticdl_tpu.parallel import ring_attention as jring
from elasticdl_tpu_torch.ops import flash_attention as tfa
from elasticdl_tpu_torch.parallel import ring_attention as tring

TOL = 2e-5
WINDOWS = [64, 200, 1000]    # as tests/test_window_attention.py at t=384


def make_qkv(b=2, h=2, t=256, d=64, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, t, d).astype(np.float32) for _ in range(3)]


def both(arrays, dtype=np.float32):
    """The same numpy arrays as JAX and torch inputs."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def close(got, want, tol=TOL):
    np.testing.assert_allclose(
        got.float().numpy() if isinstance(got, torch.Tensor)
        else np.asarray(got, np.float32),
        np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [256, 1024])
def test_flash_matches_jax_kernel_and_reference(causal, t):
    """t=1024 gives the JAX kernel a K grid of two 512-wide blocks (its
    carry across ki and the dead-block skip engage)."""
    b, h = (2, 2) if t == 256 else (1, 1)
    (jq, jk, jv), (q, k, v) = both(make_qkv(b=b, h=h, t=t, seed=t))
    scale = 64 ** -0.5
    want = jfa.flash_attention(jq, jk, jv, causal=causal, interpret=True)
    want_ref = jfa._attention_ref(jq, jk, jv, causal, scale)
    got = tfa.flash_attention(q, k, v, causal=causal)
    close(got, want)
    close(got, want_ref)
    close(tfa._attention_ref(q, k, v, causal, scale), want_ref)


@pytest.mark.parametrize("window", WINDOWS)
def test_flash_window_matches_jax(window):
    (jq, jk, jv), (q, k, v) = both(make_qkv(b=1, h=2, t=384, seed=0))
    scale = 64 ** -0.5
    want = jfa.flash_attention(jq, jk, jv, causal=True, interpret=True,
                               window=window)
    got = tfa.flash_attention(q, k, v, causal=True, window=window)
    close(got, want)
    close(got, jfa._attention_ref(jq, jk, jv, True, scale, window=window))
    if window >= 384:
        close(got, tfa.flash_attention(q, k, v, causal=True))


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 200)])
def test_stats_match_jax_flash_forward(causal, window):
    """(out, l, m) against the JAX ``_flash_forward``'s, the residuals
    its backward kernels read."""
    (jq, jk, jv), (q, k, v) = both(make_qkv(b=1, h=2, t=384, seed=5))
    scale = 64 ** -0.5
    want = jfa._flash_forward(jq, jk, jv, causal, scale, 128, 128, True,
                              window=window)
    got = tfa.flash_forward(q, k, v, causal=causal, window=window)
    assert got[1].dtype == got[2].dtype == torch.float32
    assert got[1].shape == got[2].shape == (1, 2, 384)
    for g, w in zip(got, want):
        close(g, w)


def test_bfloat16_rounds_p_as_the_jax_kernel():
    (jq, jk, jv), (q, k, v) = both(make_qkv(b=1, h=2, t=256, seed=7),
                                   "bfloat16")
    want = jfa.flash_attention(jq, jk, jv, causal=True, interpret=True)
    got = tfa.flash_attention(q, k, v, causal=True)
    assert got.dtype == torch.bfloat16
    close(got, want, tol=2e-2)


def test_ring_layout_matches_jax_attention_local():
    """[B, T, H, D] in and out, through the JAX kernel in interpret
    mode on one side and the port's wrapper on the other."""
    rng = np.random.RandomState(3)
    arrays = [rng.randn(2, 128, 2, 64).astype(np.float32)
              for _ in range(3)]
    (jq, jk, jv), (q, k, v) = both(arrays)
    for window in (0, 40):
        want = jring.attention_local(jq, jk, jv, causal=True,
                                     mode="interpret", window=window)
        got = tring.ring_attention(q, k, v, None, causal=True,
                                   window=window)
        assert got.shape == (2, 128, 2, 64)
        close(got, want)
        close(tring.attention_local(q, k, v, window=window), want)


def test_window_and_mesh_errors():
    q, k, v = (torch.from_numpy(a) for a in make_qkv(b=1, h=1, t=128))
    qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
    for call in (lambda **kw: tfa.flash_attention(q, k, v, **kw),
                 lambda **kw: tfa.flash_forward(q, k, v, **kw),
                 lambda **kw: tring.attention_local(qs, ks, vs, **kw),
                 lambda **kw: tring.ring_attention(qs, ks, vs, None, **kw)):
        with pytest.raises(ValueError, match="requires causal"):
            call(causal=False, window=64)
        with pytest.raises(ValueError, match="window must be >= 0"):
            call(causal=True, window=-1)
    # A mesh whose sp is 1 is attention_local (the ring itself runs over
    # gloo ranks in tests/test_torch_ring_attention.py).
    mesh = types.SimpleNamespace(shape={"dp": 1, "pp": 1, "ep": 1, "tp": 1,
                                        "sp": 1})
    close(tring.ring_attention(qs, ks, vs, mesh),
          tring.attention_local(qs, ks, vs).numpy())


def test_cuda_path_refuses_what_the_kernel_does_not_take():
    """The checks a CUDA tensor meets before its launch (here on CPU
    tensors, which themselves never reach them): dtypes, head dims,
    strides; grad is no longer refused.  A device that is neither CPU
    nor CUDA is refused outright."""
    q, k, v = (torch.from_numpy(a) for a in make_qkv(b=1, h=1, t=64))
    q.requires_grad_()
    tfa._check_cuda_inputs(q, k, v)
    # A gradient flows through the Function: on the CPU its backward is
    # the plain version of the backward kernels.
    tfa.flash_attention(q, k, v).sum().backward()
    out, l, m = tfa._flash_ref(q.detach(), k, v, True, 64 ** -0.5)
    want = tfa._flash_bwd_ref(q.detach(), k, v, out, l, m,
                              torch.ones_like(out), True, 64 ** -0.5)[0]
    assert torch.equal(q.grad, want)
    q = q.detach()
    with pytest.raises(TypeError, match="bfloat16"):
        tfa._check_cuda_inputs(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head_dim"):
        tfa._check_cuda_inputs(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(ValueError, match="16-byte"):
        # [.., T=64, D=64] with the head dim strided: not contiguous.
        tfa._check_cuda_inputs(q.transpose(-1, -2), k.transpose(-1, -2),
                               v.transpose(-1, -2))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


def _kernel_sources(main):
    """``csrc/<main>`` and the headers it includes, comments stripped."""
    import os
    import re

    from elasticdl_tpu_torch.ops import build

    with open(os.path.join(build.CSRC, main)) as f:
        names = [main] + re.findall(r'#include "([^"]+)"', f.read())
    code = {}
    for name in names:
        with open(os.path.join(build.CSRC, name)) as f:
            text = re.sub(r"/\*.*?\*/", "", f.read(), flags=re.S)
        code[name] = re.sub(r"//[^\n]*", "", text)
    return code


def test_forward_source_has_no_atomics():
    """B3 is deterministic by construction: no atomic operation (CUDA's
    atomic* functions, PTX atom.* or red.*) in its source or the headers
    it includes."""
    import re

    code = _kernel_sources("flash_attention.cu")
    assert set(code) >= {"flash_attention.cu", "flash_common.cuh",
                         "hopper.cuh"}
    for name, text in code.items():
        assert not re.search(r"atomic|\batom\.|\bred\.", text, re.I), name


def test_flagship_forward_dispatches_to_the_wgmma_kernel():
    """bf16 at head_dim 64 (the flagship LM's attention) reaches the kernel
    built on wgmma and TMA; bf16 at head_dim 128 keeps the mma.sync
    kernel and float32 the FMA kernels: a dispatch by dtype and D, with
    an error for anything else.  B3 and B3p (the unnormalised forward)
    share the dispatch, B3 with normalize 1."""
    import re

    body = _kernel_sources("flash_attention.cu")["flash_attention.cu"]
    for c_entry, normalize in (("edl_flash_attention_fwd", 1),
                               ("edl_flash_attention_partial_fwd", 0)):
        at = body[body.index("int %s(" % c_entry):]
        assert re.search(r"return forward\([^;]*dtype, %d, stream\);"
                         % normalize, at[:at.index("\n}\n")])
    entry = body[body.index("int dispatch("):]
    bf16 = entry[entry.index("if (dtype == 1) {"):]
    assert re.match(r"if \(dtype == 1\) \{\s*if \(D == 64\) return "
                    r"launch_wgmma\(prm, B, stream\);", bf16)
    assert "flash_fwd_bf16<128, 1>" in bf16[:bf16.index("}")]
    f32 = entry[entry.index("if (dtype == 0) {"):]
    f32 = f32[:f32.index("}")]
    assert "flash_fwd_f32<64>" in f32 and "flash_fwd_f32<128>" in f32
    assert "return (int)cudaErrorInvalidValue;" in entry
    launcher = body[body.index("int launch_wgmma("):]
    launcher = launcher[:launcher.index("\n}\n")]
    assert "flash_fwd_wgmma<true>" in launcher
    assert "kernel<<<" in launcher
    assert "encode_rows_bf16" in launcher
    for op in ("wgmma_ss(", "wgmma_rs_mn(", "tma_load_4d(",
               "named_barrier_arrive("):
        assert op in body, op
