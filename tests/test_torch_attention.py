"""The port's attention (``dmlc_core_tpu_torch/ops/attention.py``) against
the JAX package.

The CPU runs the plain versions of the three flash kernels (forward,
dK/dV, dQ) through the same ``FlashAttention`` Function the card runs the
kernels through.  They are held to JAX's dense oracle
(``reference_attention`` and its ``jax.vjp``) and to the library's own
Pallas kernels (``jax.experimental.pallas.ops.tpu.flash_attention``, the
kernels the JAX package calls on a TPU) run in TPU interpret mode.

Tolerances: bf16 inputs and outputs.  ``o`` within 2^-7 · max|ref| (one
bf16 rounding of the output is 2^-8 relative; the two sides round at
different points); dQ, dK, dV within 2^-6 · max|ref| (the library also
rounds P and dS to bf16 before its backward products).  In f32 against
autograd of the oracle the plain formulas agree to 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as jax_flash

from dmlc_core_tpu.ops.attention import local_attention as jax_local
from dmlc_core_tpu.parallel.ring_attention import (
    reference_attention as jax_reference)
from dmlc_core_tpu_torch.base.logging import Error
from dmlc_core_tpu_torch.ops import attention as ta
from dmlc_core_tpu_torch.parallel.ring_attention import reference_attention

# a few intra-op threads per test process: the suite runs several
# processes on the host's cores
torch.set_num_threads(2)

O_TOL = 2.0 ** -7
GRAD_TOL = 2.0 ** -6
#: [B, S, H, D]: a shape the card's kernels take (S a multiple of the
#: library's 128 blocks) and an odd one (S not a tile multiple, D 16)
SHAPES = [(1, 256, 2, 64), (2, 40, 3, 16)]
KERNELS = (ta.flash_fwd_kernel, ta.flash_bwd_dkv_kernel,
           ta.flash_bwd_dq_kernel)


def _inputs(shape, seed=0, dtype=torch.bfloat16):
    """q, k, v, dO from a numpy seed, in ``dtype``."""
    rng = np.random.default_rng([seed, *shape])
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                 .to(dtype) for _ in range(4))


def _jax(t, layout="bshd"):
    """A torch tensor as a JAX array of the same dtype (``bhsd``: the
    library's [B, H, S, D])."""
    a = t.detach().float().numpy()
    if layout == "bhsd":
        a = a.transpose(0, 2, 1, 3)
    dt = jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32
    return jnp.asarray(a, dt)


def _np(a, layout="bshd"):
    out = np.asarray(jnp.asarray(a).astype(jnp.float32))
    return out.transpose(0, 2, 1, 3) if layout == "bhsd" else out


def _port(q, k, v, do, causal, scale=None):
    """``o`` and ``(dq, dk, dv)`` through ``FlashAttention`` (the plain
    versions on these CPU tensors)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = ta.FlashAttention.apply(*leaves, causal, scale)
    grads = torch.autograd.grad(o, leaves, do)
    return o.detach(), grads


def _close(got, ref, tol, what):
    got = (got.detach().float().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float32))
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max())
    bound = tol * float(np.abs(ref).max())
    assert err <= bound, f"{what}: max error {err} > {bound}"


@pytest.fixture(autouse=True)
def _no_launches():
    for fn in KERNELS:
        fn.launches = 0
    yield
    assert [fn.launches for fn in KERNELS] == [0, 0, 0], \
        "a CUDA kernel wrapper launched on the CPU"


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_reference_and_vjp(shape, causal):
    q, k, v, do = _inputs(shape)
    o, grads = _port(q, k, v, do, causal)
    ref, vjp = jax.vjp(lambda a, b, c: jax_reference(a, b, c, causal=causal),
                       _jax(q), _jax(k), _jax(v))
    assert o.dtype == torch.bfloat16
    _close(o, _np(ref), O_TOL, "o")
    for name, g, r in zip(("dq", "dk", "dv"), grads, vjp(_jax(do))):
        assert g.dtype == torch.bfloat16
        _close(g, _np(r), GRAD_TOL, name)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_library_kernels_in_interpret_mode(causal):
    # the Pallas kernels the JAX package calls on a TPU, B 1, H 2, S 256,
    # D 64 in their [B, H, S, D] layout
    q, k, v, do = _inputs((1, 256, 2, 64), seed=1)
    scale = 64 ** -0.5
    o, grads = _port(q, k, v, do, causal, scale)
    with pltpu.force_tpu_interpret_mode():
        ref, vjp = jax.vjp(
            lambda a, b, c: jax_flash.flash_attention(
                a, b, c, causal=causal, sm_scale=scale),
            _jax(q, "bhsd"), _jax(k, "bhsd"), _jax(v, "bhsd"))
        ref_grads = vjp(_jax(do, "bhsd"))
    _close(o, _np(ref, "bhsd"), O_TOL, "o")
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        _close(g, _np(r, "bhsd"), GRAD_TOL, name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_formulas_match_autograd_of_the_oracle_in_f32(shape, causal):
    q, k, v, do = _inputs(shape, seed=2, dtype=torch.float32)
    o, grads = _port(q, k, v, do, causal)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = reference_attention(*leaves, causal=causal)
    ref_grads = torch.autograd.grad(ref, leaves, do)
    _close(o, ref.detach().numpy(), 1e-5, "o")
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        _close(g, r.numpy(), 1e-5, name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_lse_is_the_log_sum_exp_of_the_scores(shape, causal):
    q, k, _, _ = _inputs(shape, seed=3)
    B, S, H, D = shape
    _, lse = ta.flash_fwd_plain(q, k, k, causal, D ** -0.5)
    s = np.einsum("bqhd,bkhd->bhqk", q.double().numpy(),
                  k.double().numpy()) * D ** -0.5
    if causal:
        s = np.where(np.tril(np.ones((S, S), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    np.testing.assert_allclose(lse.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_reference_matches_jax_reference(dtype, causal):
    q, k, v, do = _inputs((2, 24, 3, 8), seed=4, dtype=dtype)
    tol = 1e-5 if dtype == torch.float32 else O_TOL
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = reference_attention(*leaves, causal=causal, scale=0.3)
    grads = torch.autograd.grad(out, leaves, do)
    ref, vjp = jax.vjp(
        lambda a, b, c: jax_reference(a, b, c, causal=causal, scale=0.3),
        _jax(q), _jax(k), _jax(v))
    assert out.dtype == dtype
    _close(out, _np(ref), tol, "out")
    # bf16: the two backward passes round at different points
    for name, g, r in zip(("dq", "dk", "dv"), grads, vjp(_jax(do))):
        _close(g, _np(r), 2 * tol, name)


@pytest.mark.parametrize("shape", [(1, 256, 2, 64), (2, 40, 3, 128),
                                   (1, 8, 1, 80)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
def test_flash_eligible_is_false_on_the_cpu(shape, dtype):
    assert not ta.flash_eligible(torch.zeros(shape, dtype=dtype))


@pytest.mark.parametrize("causal", [False, True])
def test_local_attention_on_the_cpu_is_the_oracle(causal):
    # the dispatcher takes the dense oracle here and launches no kernel
    # (the autouse fixture checks the counts), as JAX's dispatcher does
    # off the TPU
    q, k, v, _ = _inputs((1, 256, 2, 64), seed=5)
    out = ta.local_attention(q, k, v, causal=causal)
    assert torch.equal(out, reference_attention(q, k, v, causal=causal))
    _close(out, _np(jax_local(_jax(q), _jax(k), _jax(v), causal=causal)),
           O_TOL, "local_attention")


def test_kernel_wrappers_refuse_cpu_tensors():
    q, k, v, do = _inputs((1, 64, 2, 64))
    lse = torch.zeros(1, 2, 64)
    with pytest.raises(Error, match="CUDA"):
        ta.flash_fwd_kernel(q, k, v, False, 0.125)
    with pytest.raises(Error, match="CUDA"):
        ta.flash_bwd_dkv_kernel(q, k, v, do, lse, lse, False, 0.125)
    with pytest.raises(Error, match="CUDA"):
        ta.flash_bwd_dq_kernel(q, k, v, do, lse, lse, False, 0.125)


def test_mask_value_is_the_library_default():
    assert ta.MASK_VALUE == jax_flash.DEFAULT_MASK_VALUE


# --- the tile arithmetic of the CUDA kernels, emulated -----------------
#
# flash_fwd, flash_bwd_dkv and flash_bwd_dq (csrc/attention.cu) cannot run
# on the CPU.  These torch emulations follow their per-tile recurrences at
# their tile sizes and with their bf16 rounding points, in f32, and are
# held to the plain versions within chip_smoke.py's own tolerances (O_TOL,
# GRAD_TOL, LSE_TOL): a rounding point in the wrong place shows here
# before any chip time is spent.  The kernels' f32 sums run in other
# orders, well inside these bounds.

LSE_TOL = 1e-4
TILE = 64                      # the kernels' query and key tile rows
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
#: chip_smoke.py's small ATTN_SHAPES: tail tiles (S 200, 77, 130) and the
#: head dims 64, 80, 128
EMU_SHAPES = [(2, 200, 3, 64), (1, 77, 2, 80), (2, 130, 2, 128)]


def _bhsd(t):
    return t.float().transpose(1, 2)


def _emulate_fwd(q, k, v, causal, scale):
    """flash_fwd's loop: per 64-row query tile, the key tiles up to the
    diagonal; scores in log2 units with masked keys at MASK_VALUE; the
    running max m and sum l, O rescaled by exp2(m_old − m_new) before
    O += bf16(P) V; then o = O / l in bf16 and lse = m·ln2 + log l."""
    B, S, H, D = q.shape
    qf, kf, vf = _bhsd(q), _bhsd(k), _bhsd(v)
    o = torch.empty(B, H, S, D)
    lse = torch.empty(B, H, S)
    for q0 in range(0, S, TILE):
        rows = torch.arange(q0, min(q0 + TILE, S))
        m = torch.full((B, H, len(rows)), -float("inf"))
        l = torch.zeros(B, H, len(rows))
        acc = torch.zeros(B, H, len(rows), D)
        n_kt = -(-S // TILE)
        if causal:
            n_kt = min(q0 // TILE + 1, n_kt)
        for k0 in range(0, n_kt * TILE, TILE):
            keys = torch.arange(k0, min(k0 + TILE, S))
            s2 = qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2)
            s2 = s2 * (scale * LOG2E)
            if causal:
                s2 = s2.masked_fill(keys[None, :] > rows[:, None],
                                    ta.MASK_VALUE)
            m_new = torch.maximum(m, s2.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s2 - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + (p.to(torch.bfloat16).float()
                                           @ vf[:, :, keys])
            m = m_new
        o[:, :, rows] = acc / l[..., None]
        lse[:, :, rows] = m * LN2 + torch.log(l)
    return o.transpose(1, 2).to(torch.bfloat16), lse


def _emulate_dkv(q, k, v, do, lse, di, causal, scale):
    """flash_bwd_dkv's loop: query tiles of 64 rows at D 64, 32 above;
    per tile Pᵀ = exp2(scale·log2e·Sᵀ − log2e·lse) (masked to 0), dV +=
    bf16(Pᵀ) dO, dSᵀ = Pᵀ ∘ (V dOᵀ − di), dK += bf16(dSᵀ) Q; dK·scale at
    the store.  Every key row at once: the kernel's key tiles do not
    change a rounding point, and the query tiles a key tile skips under
    causal add only masked zeros."""
    B, S, H, D = q.shape
    bq = 64 if D <= 64 else 32
    qf, kf, vf, dof = _bhsd(q), _bhsd(k), _bhsd(v), _bhsd(do)
    keys = torch.arange(S)
    dk = torch.zeros(B, H, S, D)
    dv = torch.zeros(B, H, S, D)
    for q0 in range(0, S, bq):
        qs = torch.arange(q0, min(q0 + bq, S))
        st = kf @ qf[:, :, qs].transpose(-1, -2)            # [B, H, S, bq]
        pt = torch.exp2(st * (scale * LOG2E)
                        - lse[:, :, None, qs] * LOG2E)
        if causal:
            pt = pt.masked_fill(keys[:, None] > qs[None, :], 0.0)
        dv += pt.to(torch.bfloat16).float() @ dof[:, :, qs]
        dpt = vf @ dof[:, :, qs].transpose(-1, -2)
        dst = pt * (dpt - di[:, :, None, qs])
        dk += dst.to(torch.bfloat16).float() @ qf[:, :, qs]
    return ((dk * scale).transpose(1, 2).to(torch.bfloat16),
            dv.transpose(1, 2).to(torch.bfloat16))


def _emulate_dq(q, k, v, do, lse, di, causal, scale):
    """flash_bwd_dq's loop: per 64-row query tile, the key tiles up to the
    diagonal; per tile P = exp2(scale·log2e·S − log2e·lse) (masked keys
    to 0), dS = P ∘ (dO Vᵀ − di) in f32, dQ += bf16(dS) K; dQ·scale at
    the store."""
    B, S, H, D = q.shape
    qf, kf, vf, dof = _bhsd(q), _bhsd(k), _bhsd(v), _bhsd(do)
    dq = torch.empty(B, H, S, D)
    for q0 in range(0, S, TILE):
        rows = torch.arange(q0, min(q0 + TILE, S))
        l2 = lse[:, :, rows, None] * LOG2E
        d = di[:, :, rows, None]
        acc = torch.zeros(B, H, len(rows), D)
        n_kt = -(-S // TILE)
        if causal:
            n_kt = min(q0 // TILE + 1, n_kt)
        for k0 in range(0, n_kt * TILE, TILE):
            keys = torch.arange(k0, min(k0 + TILE, S))
            s = qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2)
            p = torch.exp2(s * (scale * LOG2E) - l2)
            if causal:
                p = p.masked_fill(keys[None, :] > rows[:, None], 0.0)
            dp = dof[:, :, rows] @ vf[:, :, keys].transpose(-1, -2)
            ds = p * (dp - d)
            acc += ds.to(torch.bfloat16).float() @ kf[:, :, keys]
        dq[:, :, rows] = acc * scale
    return dq.transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", EMU_SHAPES)
def test_forward_tile_arithmetic_matches_plain(shape, causal):
    q, k, v, _ = _inputs(shape, seed=6)
    scale = shape[-1] ** -0.5
    o, lse = _emulate_fwd(q, k, v, causal, scale)
    o_p, lse_p = ta.flash_fwd_plain(q, k, v, causal, scale)
    _close(o, o_p.float().numpy(), O_TOL, "o")
    err = float((lse - lse_p).abs().max())
    assert err <= LSE_TOL, f"lse off by {err}"


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", EMU_SHAPES)
def test_dkv_tile_arithmetic_matches_plain(shape, causal):
    q, k, v, do = _inputs(shape, seed=7)
    scale = shape[-1] ** -0.5
    o, lse = ta.flash_fwd_plain(q, k, v, causal, scale)
    di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    dk, dv = _emulate_dkv(q, k, v, do, lse, di, causal, scale)
    dk_p, dv_p = ta.flash_bwd_dkv_plain(q, k, v, do, lse, di, causal, scale)
    _close(dk, dk_p.float().numpy(), GRAD_TOL, "dk")
    _close(dv, dv_p.float().numpy(), GRAD_TOL, "dv")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", EMU_SHAPES)
def test_dq_tile_arithmetic_matches_plain(shape, causal):
    q, k, v, do = _inputs(shape, seed=8)
    scale = shape[-1] ** -0.5
    o, lse = ta.flash_fwd_plain(q, k, v, causal, scale)
    di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    dq = _emulate_dq(q, k, v, do, lse, di, causal, scale)
    dq_p = ta.flash_bwd_dq_plain(q, k, v, do, lse, di, causal, scale)
    _close(dq, dq_p.float().numpy(), GRAD_TOL, "dq")
