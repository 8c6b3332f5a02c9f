"""The port's three transposed kernels (their plain versions, reached
through the wrappers on CPU tensors) against the JAX package's Pallas
kernels in interpret mode, on the same numpy inputs.

Tolerance rtol 1e-5 / atol 1e-5: both sides add exact f32 products of 0/1
bits and f32 (or bf16-valued) features in f32; only the order of the sums
differs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnadvisor_osdi21_tpu.graphs.hybrid import build_residual_stream
from gnnadvisor_osdi21_tpu.ops import spmm_pallas
from gnnadvisor_osdi21_tpu_torch.ops import spmm_cuda

DIMS = (5, 16, 22)
DTYPES = ("float32", "bfloat16")
TOL = dict(rtol=1e-5, atol=1e-5)


def _both(x: np.ndarray, dtype: str):
    """The same values for both sides: bf16 rounds the same way in each."""
    j = jnp.asarray(x).astype(dtype)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    np.testing.assert_array_equal(
        np.asarray(j, dtype=np.float32), t.float().numpy()
    )
    return j, t


def _slab(rng, r, k, nnz):
    rows, cols = rng.integers(0, r, nnz), rng.integers(0, k, nnz)
    return spmm_pallas.pack_slab_bits_t(rows, cols, r, k)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", DIMS)
def test_slab_matmul_t_hot(d, dtype):
    rng = np.random.default_rng(d)
    r, k = 256, 64
    bits = _slab(rng, r, k, 900)
    xj, xt = _both(rng.standard_normal((d, k)).astype(np.float32), dtype)
    want = np.asarray(spmm_pallas.slab_matmul_t(
        jnp.asarray(bits), xj, block_cols=64, interpret=True))
    got = spmm_cuda.slab_matmul_t(torch.from_numpy(bits), xt)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", DIMS)
def test_slab_matmul_t_diag(d, dtype):
    rng = np.random.default_rng(10 + d)
    r, b = 512, 128
    bits = _slab(rng, r, b, 2000)
    xj, xt = _both(rng.standard_normal((d, r)).astype(np.float32), dtype)
    want = np.asarray(spmm_pallas.slab_matmul_t(
        jnp.asarray(bits), xj, table_block_cols=b, block_cols=64,
        interpret=True))
    got = spmm_cuda.slab_matmul_t(torch.from_numpy(bits), xt, b)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", DIMS)
def test_fused_slab_matmul_t(d, dtype):
    rng = np.random.default_rng(20 + d)
    r, b, k = 256, 128, 64
    dbits, hbits = _slab(rng, r, b, 900), _slab(rng, r, k, 500)
    xj, xt = _both(rng.standard_normal((d, r)).astype(np.float32), dtype)
    hj, ht = _both(rng.standard_normal((d, k)).astype(np.float32), dtype)
    want = np.asarray(spmm_pallas.fused_slab_matmul_t(
        jnp.asarray(dbits), jnp.asarray(hbits), xj, hj, diag_b=b,
        block_cols=64, interpret=True))
    got = spmm_cuda.fused_slab_matmul_t(
        torch.from_numpy(dbits), torch.from_numpy(hbits), xt, ht, b)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", DIMS)
def test_residual_combine_t(d, dtype):
    """Blocks the stream visits match the Pallas kernel; the block no tile
    visits (block 2) comes out as zeros, which the JAX caller's select
    produces (hybrid_agg.py:377-384)."""
    rng = np.random.default_rng(30 + d)
    res_ob, res_tile, num_rows, col_space = 32, 32, 128, 64
    rs = np.concatenate([rng.integers(0, 64, 300), rng.integers(96, 128, 100)])
    rd = rng.integers(0, col_space, 400)
    rs, rd = np.unique(np.stack([rs, rd]), axis=1)
    _, res_dst, _, mask_s, t2b, _ = build_residual_stream(
        rs, rd, col_space, num_rows, res_tile, res_ob)
    table = rng.standard_normal((d, col_space)).astype(np.float32)
    rows_t = np.ascontiguousarray(table[:, res_dst])
    rj, rt = _both(rows_t, dtype)
    want = np.asarray(spmm_pallas.residual_combine_t(
        rj, jnp.asarray(mask_s), jnp.asarray(t2b), num_rows, res_ob,
        interpret=True))
    ptr = np.searchsorted(t2b, np.arange(num_rows // res_ob + 1))
    got = spmm_cuda.residual_combine_t(
        rt, torch.from_numpy(mask_s), torch.from_numpy(t2b),
        torch.from_numpy(ptr.astype(np.int32)), num_rows, res_ob).numpy()
    visited = np.repeat(np.isin(np.arange(num_rows // res_ob), t2b), res_ob)
    assert not visited.all()
    np.testing.assert_allclose(got[:, visited], want[:, visited], **TOL)
    assert not got[:, ~visited].any()


def test_slab_width_guard():
    """K >= 65536 overflows the uint16 bit test; both packages refuse it."""
    bits = np.zeros((4096, 16), dtype=np.uint16)  # K = 65536
    x = np.zeros((4, 65536), dtype=np.float32)
    with pytest.raises(AssertionError, match="overflows"):
        spmm_pallas.slab_matmul_t(jnp.asarray(bits), jnp.asarray(x),
                                  block_cols=16, interpret=True)
    with pytest.raises(ValueError, match="overflows"):
        spmm_cuda.slab_matmul_t(torch.from_numpy(bits), torch.from_numpy(x))


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "device"])
def test_wrapper_rejects_bad_operands(bad):
    bits = torch.zeros((4, 256), dtype=torch.uint16)
    x = torch.zeros((8, 64))
    if bad == "dtype":
        x = x.to(torch.float16)
    elif bad == "shape":
        x = torch.zeros((8, 32))
    elif bad == "contiguity":
        x = torch.zeros((64, 8)).t()
    else:
        x = torch.zeros((8, 64), device="meta")
    with pytest.raises(ValueError):
        spmm_cuda.slab_matmul_t(bits, x)
