"""The port's three row-major kernels (their plain versions, reached
through the wrappers on CPU tensors) against the JAX package's Pallas
kernels in interpret mode, or, for the residual's gather from a table,
its row-major residual tier's reference path, on the same numpy inputs.

Tolerance rtol 1e-5 / atol 1e-5: both sides add exact f32 products of 0/1
bits and f32 (or bf16-valued) features in f32; only the order of the sums
differs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnadvisor_osdi21_tpu.graphs.hybrid import build_residual_stream
from gnnadvisor_osdi21_tpu.ops import spmm_pallas
from gnnadvisor_osdi21_tpu.ops.hybrid_agg import (
    HybridTensors as jax_tensors,
    _residual_aggregate,
)
from gnnadvisor_osdi21_tpu_torch.ops import spmm_cuda

DIMS = (5, 16, 22, 64)
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
def test_slab_matmul_hot(d, dtype):
    rng = np.random.default_rng(d)
    r, k = 256, 64
    bits = _slab(rng, r, k, 900)
    xj, xt = _both(rng.standard_normal((k, d)).astype(np.float32), dtype)
    want = np.asarray(spmm_pallas.hot_slab_matmul(
        jnp.asarray(bits), xj, block_rows=64, interpret=True))
    got = spmm_cuda.slab_matmul(torch.from_numpy(bits), xt)
    assert got.dtype == torch.float32 and got.shape == (r, d)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", DIMS)
def test_slab_matmul_diag(d, dtype):
    rng = np.random.default_rng(10 + d)
    r, b = 512, 128
    bits = _slab(rng, r, b, 2000)
    xj, xt = _both(rng.standard_normal((r, d)).astype(np.float32), dtype)
    want = np.asarray(spmm_pallas.diag_slab_matmul(
        jnp.asarray(bits), xj, b, block_rows=64, interpret=True))
    got = spmm_cuda.slab_matmul(torch.from_numpy(bits), xt, b)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("wiring", ["hot", "diag"])
def test_slab_matmul_both_wirings_of_the_pallas_entry(wiring):
    """``slab_matmul`` itself, as the JAX package's two wirings call it,
    with D = 96 (GIN's input width)."""
    rng = np.random.default_rng(40)
    r, k, d = 256, 128, 96
    bits = _slab(rng, r, k, 1500)
    block = None if wiring == "hot" else k
    x = rng.standard_normal((k if block is None else r, d)).astype(np.float32)
    want = np.asarray(spmm_pallas.slab_matmul(
        jnp.asarray(bits), jnp.asarray(x), table_block_rows=block,
        block_rows=64, interpret=True))
    got = spmm_cuda.slab_matmul(torch.from_numpy(bits), torch.from_numpy(x),
                                block)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", DIMS)
def test_fused_slab_matmul(d, dtype):
    rng = np.random.default_rng(20 + d)
    r, b, k = 256, 128, 64
    dbits, hbits = _slab(rng, r, b, 900), _slab(rng, r, k, 500)
    xj, xt = _both(rng.standard_normal((r, d)).astype(np.float32), dtype)
    hj, ht = _both(rng.standard_normal((k, d)).astype(np.float32), dtype)
    want = np.asarray(spmm_pallas.fused_slab_matmul(
        jnp.asarray(dbits), jnp.asarray(hbits), xj, hj, diag_b=b,
        block_rows=64, interpret=True))
    got = spmm_cuda.fused_slab_matmul(
        torch.from_numpy(dbits), torch.from_numpy(hbits), xt, ht, b)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _residual_stream(rng, res_ob, res_tile, num_rows, col_space, edges,
                     rows_of=None):
    """A residual stream over ``edges`` random (row, col) pairs, rows drawn
    by ``rows_of`` (default: all rows): ``build_residual_stream``'s
    output plus ``block_ptr`` and the composed slot ids
    ``res_gather[res_dst]`` (pad slots name ``res_gather[0]``)."""
    rs = (rng.integers(0, num_rows, edges) if rows_of is None
          else rows_of(rng))
    rd = rng.integers(0, col_space, len(rs))
    rs, rd = np.unique(np.stack([rs, rd]), axis=1)
    res_gather, res_dst, mask, _, t2b, _ = build_residual_stream(
        rs, rd, col_space, num_rows, res_tile, res_ob)
    ptr = np.searchsorted(t2b, np.arange(num_rows // res_ob + 1))
    return dict(rs=rs, rd=rd, gather=res_gather, dst=res_dst, mask=mask,
                t2b=t2b, ptr=ptr.astype(np.int32),
                src=res_gather[res_dst].astype(np.int32))


def _jax_residual(x, st, stage, num_rows, res_ob, res_tile):
    """The JAX package's row-major residual tier (``_residual_aggregate``,
    its reference path on the CPU) with single- or two-stage ids."""
    single = stage == "single"
    z = jnp.zeros(num_rows, jnp.float32)
    ht = jax_tensors(
        degrees=z, row_mask=z, diag_bits=None, hot_bits=None, hot_ids=None,
        res_gather=None if single else jnp.asarray(st["gather"]),
        res_dst=jnp.asarray(st["src"] if single else st["dst"]),
        res_mask=jnp.asarray(st["mask"]), res_mask_s=None,
        res_t2b=jnp.asarray(st["t2b"]), num_rows=num_rows, res_ob=res_ob,
        res_tile=res_tile)
    return np.asarray(_residual_aggregate(x, ht))


@pytest.mark.parametrize("addend", [False, True], ids=["no_addend", "addend"])
@pytest.mark.parametrize("source", ["rows", "single", "two"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", DIMS)
def test_residual_combine(d, dtype, source, addend):
    """Blocks the stream visits match the JAX package; the block no tile
    visits (block 2) comes out as zeros, which the JAX caller's select
    produces (hybrid_agg.py:259-268), or as the addend.

    ``rows``: the gathered slot rows with ``res_src = arange``, against the
    Pallas kernel in interpret mode.  ``single``/``two``: the table itself
    with ``res_src = res_gather[res_dst]``, against the JAX tier with
    single- or two-stage ids; in ``single`` the pad slots name row 0.
    With an addend the result is ``addend + r``, bit for bit."""
    rng = np.random.default_rng(30 + d)
    res_ob, res_tile, num_rows, col_space = 64, 32, 256, 96
    st = _residual_stream(
        rng, res_ob, res_tile, num_rows, col_space, 600,
        rows_of=lambda g: np.concatenate([g.integers(0, 128, 400),
                                          g.integers(192, 256, 200)]))
    table = rng.standard_normal((col_space, d)).astype(np.float32)
    visited = np.repeat(np.isin(np.arange(num_rows // res_ob), st["t2b"]),
                        res_ob)
    assert not visited.all()
    src = st["src"]
    if source == "rows":
        xj, xt = _both(np.ascontiguousarray(table[st["dst"]]), dtype)
        want = np.asarray(spmm_pallas.residual_combine(
            xj, jnp.asarray(st["mask"]), jnp.asarray(st["t2b"]), num_rows,
            res_ob, interpret=True))
        src = np.arange(len(src), dtype=np.int32)
    else:
        xj, xt = _both(table, dtype)
        want = _jax_residual(xj, st, source, num_rows, res_ob, res_tile)
        if source == "single":
            pads = ~st["mask"].any(axis=0)
            assert pads.any()
            src = np.where(pads, 0, src).astype(np.int32)
    args = (torch.from_numpy(src), torch.from_numpy(st["mask"]),
            torch.from_numpy(st["t2b"]), torch.from_numpy(st["ptr"]),
            num_rows, res_ob)
    got = spmm_cuda.residual_combine(xt, *args).numpy()
    assert got.shape == (num_rows, d) and got.dtype == np.float32
    np.testing.assert_allclose(got[visited], want[visited], **TOL)
    assert not got[~visited].any()
    if addend:
        h = rng.standard_normal((num_rows, d)).astype(np.float32)
        with_h = spmm_cuda.residual_combine(
            xt, *args, addend=torch.from_numpy(h)).numpy()
        np.testing.assert_array_equal(with_h, h + got)
        np.testing.assert_array_equal(with_h[~visited], h[~visited])


@pytest.mark.parametrize("source", ["rows", "x"])
def test_residual_combine_against_the_edges(source):
    """The plain version sums exactly the residual edges: one slot row per
    (block, destination) pair, added into every row of the block that has
    the destination as a neighbour, whether the slot rows come gathered
    (``rows``) or straight from the table by ``res_src`` (``x``)."""
    rng = np.random.default_rng(50)
    res_ob, res_tile, num_rows, col_space, d = 128, 64, 512, 300, 7
    st = _residual_stream(rng, res_ob, res_tile, num_rows, col_space, 3000)
    table = rng.standard_normal((col_space, d)).astype(np.float32)
    if source == "rows":
        x, src = table[st["dst"]], np.arange(len(st["src"]), dtype=np.int32)
    else:
        x, src = table, st["src"]
    got = spmm_cuda.residual_combine(
        torch.from_numpy(x), torch.from_numpy(src),
        torch.from_numpy(st["mask"]), torch.from_numpy(st["t2b"]),
        torch.from_numpy(st["ptr"]), num_rows, res_ob).numpy()
    want = np.zeros((num_rows, d), np.float32)
    np.add.at(want, st["rs"], table[st["rd"]])
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("bad", ["mask dtype", "mask shape", "res_ob",
                                 "t2b dtype", "tiles", "src dtype",
                                 "src length", "src range", "addend shape"])
def test_residual_wrapper_rejects_bad_operands(bad):
    x = torch.zeros((100, 8))
    src = torch.arange(64, dtype=torch.int32)
    mask = torch.zeros((2, 64), dtype=torch.uint32)
    t2b = torch.tensor([0, 1], dtype=torch.int32)
    ptr = torch.tensor([0, 1, 2], dtype=torch.int32)
    ob = 64
    addend = None
    if bad == "mask dtype":
        mask = torch.zeros((2, 64), dtype=torch.int32)
    elif bad == "mask shape":
        mask = torch.zeros((2, 32), dtype=torch.uint32)
    elif bad == "res_ob":
        ob = 96
    elif bad == "t2b dtype":
        t2b = t2b.to(torch.int64)
    elif bad == "tiles":
        src = torch.arange(63, dtype=torch.int32)
        mask = torch.zeros((2, 63), dtype=torch.uint32)
    elif bad == "src dtype":
        src = src.to(torch.int64)
    elif bad == "src length":
        src = torch.arange(62, dtype=torch.int32)
    elif bad == "src range":
        src = torch.arange(64, dtype=torch.int32) + 40  # past x's 100 rows
    else:
        addend = torch.zeros((128, 7))
    with pytest.raises(ValueError):
        spmm_cuda.residual_combine(x, src, mask, t2b, ptr, 128, ob,
                                   addend=addend)


@pytest.mark.parametrize("bad", ["hot rows", "diag rows", "fused width"])
def test_slab_wrappers_reject_bad_operands(bad):
    bits = torch.zeros((4, 256), dtype=torch.uint16)  # K = 64, R = 256
    with pytest.raises(ValueError):
        if bad == "hot rows":
            spmm_cuda.slab_matmul(bits, torch.zeros((32, 8)))
        elif bad == "diag rows":
            spmm_cuda.slab_matmul(bits, torch.zeros((128, 8)), 64)
        else:
            spmm_cuda.fused_slab_matmul(
                bits, bits, torch.zeros((256, 8)), torch.zeros((64, 4)), 64)
