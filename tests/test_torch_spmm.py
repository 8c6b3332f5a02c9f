"""The port's transposed kernels (their plain versions, reached through
the wrappers on CPU tensors) against the JAX package's Pallas kernels in
interpret mode, on the same numpy inputs; the hot list (``hot_list_t``,
no TPU twin) against the hot slab it is composed from.

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
from gnnadvisor_osdi21_tpu_torch.graphs.hybrid import pack_hot_list

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


def _view(x_t: torch.Tensor) -> torch.Tensor:
    """x_t as the transposed kernels take it: the transposed view of a
    padded row-major table."""
    return spmm_cuda.row_table_t(x_t).t()[: x_t.shape[0]]


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
    got = spmm_cuda.slab_matmul_t(torch.from_numpy(bits), _view(xt))
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
    got = spmm_cuda.slab_matmul_t(torch.from_numpy(bits), _view(xt), b)
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
        torch.from_numpy(dbits), torch.from_numpy(hbits), _view(xt),
        _view(ht), b)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _residual_case(d, dtype, seed):
    """A residual stream whose block 2 no tile visits, and features x_t [d,
    80] of which the slot ids reach the first 64 columns only.  Returns
    the JAX kernel's gathered operand rows_t (JAX, ``x_t[:, res_src]``),
    the port's x_t (a table view), res_src, mask_s, t2b, block_ptr, and the rows of the
    blocks the stream visits."""
    rng = np.random.default_rng(seed)
    res_ob, res_tile, num_rows, col_space = 32, 32, 128, 64
    rs = np.concatenate([rng.integers(0, 64, 300), rng.integers(96, 128, 100)])
    rd = rng.integers(0, col_space, 400)
    rs, rd = np.unique(np.stack([rs, rd]), axis=1)
    res_gather, res_dst, _, mask_s, t2b, _ = build_residual_stream(
        rs, rd, col_space, num_rows, res_tile, res_ob)
    src = res_gather[res_dst].astype(np.int32)
    table = rng.standard_normal((d, 80)).astype(np.float32)
    rj, _ = _both(np.ascontiguousarray(table[:, src]), dtype)
    _, xt = _both(table, dtype)
    ptr = np.searchsorted(t2b, np.arange(num_rows // res_ob + 1))
    visited = np.repeat(np.isin(np.arange(num_rows // res_ob), t2b), res_ob)
    assert not visited.all()
    port = (_view(xt), torch.from_numpy(src), torch.from_numpy(mask_s),
            torch.from_numpy(t2b), torch.from_numpy(ptr.astype(np.int32)),
            num_rows, res_ob)
    want = np.asarray(spmm_pallas.residual_combine_t(
        rj, jnp.asarray(mask_s), jnp.asarray(t2b), num_rows, res_ob,
        interpret=True))
    return want, port, visited


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", DIMS)
def test_residual_combine_t(d, dtype):
    """The port reads the slot rows from x_t by ``res_src`` (x_t wider than
    the ids reach); the JAX kernel takes them gathered (``x_t[:,
    res_src]``, its caller's gathers composed).  Blocks the stream visits
    match the Pallas kernel; the block no tile visits (block 2) comes out
    as zeros, which the JAX caller's select produces
    (hybrid_agg.py:377-384)."""
    want, port, visited = _residual_case(d, dtype, 30 + d)
    got = spmm_cuda.residual_combine_t(*port).numpy()
    np.testing.assert_allclose(got[:, visited], want[:, visited], **TOL)
    assert not got[:, ~visited].any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", DIMS)
def test_residual_combine_t_addend(d, dtype):
    """With an addend the result is ``addend + r`` bit for bit (the tier
    sum the transposed aggregation used to run as its own pass), and the
    unvisited block is the addend itself."""
    want, port, visited = _residual_case(d, dtype, 40 + d)
    num_rows = port[5]
    addend = torch.from_numpy(np.random.default_rng(d).standard_normal(
        (d, num_rows)).astype(np.float32))
    r = spmm_cuda.residual_combine_t(*port)
    got = spmm_cuda.residual_combine_t(*port, addend=addend)
    assert torch.equal(got, addend + r)
    np.testing.assert_allclose(got.numpy()[:, visited],
                               (addend.numpy() + want)[:, visited], **TOL)
    assert torch.equal(got[:, ~torch.from_numpy(visited)],
                       addend[:, ~torch.from_numpy(visited)])


def test_residual_combine_t_rejects_bad_ids():
    """A slot id outside x_t's columns is refused (on the card the kernel
    asserts), and so are an addend of the wrong shape and a stream whose
    ids do not match its tiles."""
    _, port, _ = _residual_case(8, "float32", 7)
    x_t, src = port[0], port[1]
    bad = src.clone()
    bad[3] = x_t.shape[1]
    with pytest.raises(ValueError, match="outside"):
        spmm_cuda.residual_combine_t(x_t, bad, *port[2:])
    with pytest.raises(ValueError, match="addend"):
        spmm_cuda.residual_combine_t(*port, addend=torch.zeros((8, 64)))
    with pytest.raises(ValueError, match="residual stream"):
        spmm_cuda.residual_combine_t(x_t, src[:-16], *port[2:])


@pytest.mark.parametrize("kernel", ["slab_matmul_t", "residual_combine_t"])
def test_transposed_view_of_a_row_table(kernel):
    """x_t given as the transposed view of a padded row-major table (the
    form the aggregation hands the kernels, ``row_table_t``) gives what the
    plain version gives on the contiguous x_t; the table holds x_t, scaled
    and cast, with zero pad columns."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((22, 64)).astype(np.float32))
    scale = torch.from_numpy(rng.random(64).astype(np.float32))
    table = spmm_cuda.row_table_t(x, torch.bfloat16, scale)
    assert table.shape == (64, 24) and not table[:, 22:].any()
    view = table.t()[:22]
    assert not view.is_contiguous()
    assert torch.equal(view, (x * scale[None, :]).to(torch.bfloat16))
    if kernel == "slab_matmul_t":
        bits = torch.from_numpy(_slab(rng, 256, 64, 900))
        got = spmm_cuda.slab_matmul_t(bits, view)
        want = spmm_cuda.slab_matmul_t_plain(bits, view.contiguous())
    else:
        _, port, _ = _residual_case(22, "bfloat16", 6)
        pad = torch.zeros((22, 16), dtype=torch.bfloat16)
        table = spmm_cuda.row_table_t(torch.cat([view, pad], dim=1))
        got = spmm_cuda.residual_combine_t(table.t()[:22], *port[1:])
        want = spmm_cuda.residual_combine_t_plain(
            torch.cat([view, pad], dim=1).contiguous(), *port[1:])
    assert torch.equal(got, want)


def test_kernels_read_only_whole_tables_in_place():
    """The transposed wrappers take x_t only as the transposed view of a
    whole row-major table (rows a multiple of 8 elements apart, 16-byte
    aligned, every row inside the storage; the fused kernel's two tables
    of one row width) and refuse any other x_t, a contiguous one too."""
    table = spmm_cuda.row_table_t(torch.zeros((22, 64)), torch.bfloat16)
    assert spmm_cuda._table_ld("x_t", table.t()[:22]) == 24
    assert spmm_cuda._table_ld("x_t", table.t()[:22], 24) == 24
    with pytest.raises(ValueError, match="of 32 columns"):
        spmm_cuda._table_ld("x_t", table.t()[:22], 32)
    wide = torch.zeros((64, 32))
    assert spmm_cuda._table_ld("x_t", wide[:, :24].t()) == 32
    bits = torch.from_numpy(_slab(np.random.default_rng(4), 256, 64, 900))
    for x_t in (
        torch.zeros((22, 64)),
        # a view that starts 8 columns in reads past the storage's last row
        wide[:, 8:].t()[:16],
        # rows 12 elements apart: not whole 16-byte pieces
        torch.zeros((64, 12)).t()[:5],
    ):
        with pytest.raises(ValueError, match="row_table_t"):
            spmm_cuda.slab_matmul_t(bits, x_t)
    x_t = table.t()[:22]
    x_hot_t = spmm_cuda.row_table_t(torch.zeros((22, 64)), torch.bfloat16,
                                    ).t()[:22]
    with pytest.raises(ValueError, match="row_table_t"):
        spmm_cuda.fused_slab_matmul_t(bits, bits, x_t.contiguous(), x_hot_t,
                                      64)
    wide_hot = torch.zeros((64, 32), dtype=torch.bfloat16)[:, :22].t()
    with pytest.raises(ValueError, match="of 24 columns"):
        spmm_cuda.fused_slab_matmul_t(bits, bits, x_t, wide_hot, 64)


def test_slab_width_guard():
    """K >= 65536 overflows the uint16 bit test; both packages refuse it."""
    bits = np.zeros((4096, 16), dtype=np.uint16)  # K = 65536
    x = np.zeros((4, 65536), dtype=np.float32)
    with pytest.raises(AssertionError, match="overflows"):
        spmm_pallas.slab_matmul_t(jnp.asarray(bits), jnp.asarray(x),
                                  block_cols=16, interpret=True)
    with pytest.raises(ValueError, match="overflows"):
        spmm_cuda.slab_matmul_t(torch.from_numpy(bits),
                                _view(torch.from_numpy(x)))


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "device"])
def test_wrapper_rejects_bad_operands(bad):
    bits = torch.zeros((4, 256), dtype=torch.uint16)
    x = _view(torch.zeros((8, 64)))
    if bad == "dtype":
        x = x.to(torch.float16)
    elif bad == "shape":
        x = _view(torch.zeros((8, 32)))
    elif bad == "contiguity":
        # not the transposed view of a row-major table
        x = torch.zeros((8, 128))[:, ::2]
    else:
        x = _view(torch.zeros((8, 64), device="meta"))
    with pytest.raises(ValueError):
        spmm_cuda.slab_matmul_t(bits, x)


HOT_DIMS = (5, 16, 22, 64, 96)


def _hot_case(d, dtype, seed):
    """A hot slab [K/16, R] with empty rows and one row holding every
    column, hot ids with pad columns (no bits) naming a zero pad row of a
    table of X > K rows, and features x_t [d, X].  Returns the JAX
    kernel's result on the slab against ``x_t[:, hot_ids]``, the port's
    x_t (a table view), hot_ptr and hot_src."""
    rng = np.random.default_rng(seed)
    r, k, x_rows, live = 256, 64, 100, 48  # columns live..k-1 are pads
    rows = rng.integers(0, r, 700)
    rows = rows[rows % 5 != 0]  # every fifth row empty
    cols = rng.integers(0, live, len(rows))
    rows = np.concatenate([rows, np.full(live, 7)])  # row 7: every column
    cols = np.concatenate([cols, np.arange(live)])
    bits = spmm_pallas.pack_slab_bits_t(rows, cols, r, k)
    hot_ids = np.full(k, x_rows - 1, dtype=np.int32)
    hot_ids[:live] = rng.permutation(x_rows - 1)[:live]
    table = rng.standard_normal((d, x_rows)).astype(np.float32)
    table[:, x_rows - 1] = 0.0  # the pad row
    xj, xt = _both(np.ascontiguousarray(table[:, hot_ids]), dtype)
    _, tt = _both(table, dtype)
    want = np.asarray(spmm_pallas.slab_matmul_t(
        jnp.asarray(bits), xj, block_cols=64, interpret=True))
    ptr, src = pack_hot_list(rows, cols, r, k, hot_ids)
    return want, _view(tt), torch.from_numpy(ptr), torch.from_numpy(src)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", HOT_DIMS)
def test_hot_list_t_matches_the_hot_slab(d, dtype):
    """The hot list composed from a slab and its hot ids, walked over x in
    place, gives the JAX slab kernel's hot wiring on the gathered table:
    empty rows 0, the full row every live column, no pad id read."""
    want, x_t, ptr, src = _hot_case(d, dtype, 50 + d)
    assert not (src == x_t.shape[1] - 1).any()  # pads have no entries
    assert int(ptr[8] - ptr[7]) == 48 and int(ptr[1] - ptr[0]) == 0
    got = spmm_cuda.hot_list_t(x_t, ptr, src)
    assert got.dtype == torch.float32 and got.shape == (d, 256)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got[:, ::5].any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", HOT_DIMS)
def test_hot_list_t_addend(d, dtype):
    """With an addend the result is ``addend + sum`` bit for bit, and the
    plain version adds in entry order from zero: the same bits as an
    explicit walk of the entries."""
    want, x_t, ptr, src = _hot_case(d, dtype, 60 + d)
    addend = torch.from_numpy(np.random.default_rng(d).standard_normal(
        (d, 256)).astype(np.float32))
    r = spmm_cuda.hot_list_t(x_t, ptr, src)
    got = spmm_cuda.hot_list_t(x_t, ptr, src, addend=addend)
    assert torch.equal(got, addend + r)
    np.testing.assert_allclose(got.numpy(), addend.numpy() + want, **TOL)
    x = x_t.float()
    walk = torch.zeros((d, 256))
    for row in range(256):
        for k in range(int(ptr[row]), int(ptr[row + 1])):
            walk[:, row] += x[:, int(src[k])]
    assert torch.equal(r, walk)


@pytest.mark.parametrize("bad", ["id", "negative id", "dtype", "ids dtype",
                                 "shape", "pointers", "addend", "not a view"])
def test_hot_list_t_rejects_bad_operands(bad):
    """A bad id (on the card: a device-side assert), a feature or id dtype
    the kernel does not take, a list whose pointers do not match it, a
    wrong addend, and an x_t that is not the view of a row-major table
    are refused."""
    _, x_t, ptr, src = _hot_case(8, "float32", 70)
    addend = None
    if bad == "id":
        src = src.clone()
        src[3] = x_t.shape[1]
    elif bad == "negative id":
        src = src.clone()
        src[-1] = -1
    elif bad == "dtype":
        x_t = _view(torch.zeros((8, 100), dtype=torch.float16))
    elif bad == "ids dtype":
        src = src.to(torch.int64)
    elif bad == "shape":
        ptr = ptr[None, :]
    elif bad == "pointers":
        src = src[:-1]
    elif bad == "addend":
        addend = torch.zeros((8, 255))
    else:
        x_t = x_t.contiguous()
    with pytest.raises(ValueError):
        spmm_cuda.hot_list_t(x_t, ptr, src, addend=addend)
