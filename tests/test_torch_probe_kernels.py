"""The probe kernels' plain versions (reached through the port's wrappers
on CPU tensors) against the JAX package's Pallas probe kernels in
interpret mode, on the same numpy inputs, for every dtype pair of their
path; and the port's slab builders against the JAX package's.

The JAX kernels are defined inside the probe scripts' ``main()`` and
cannot be imported, so this file carries copies of them: each kernel
body and its ``pallas_call`` wrapper as written there, with
``interpret=True`` added to the ``pallas_call`` (the only change).

Tolerance rtol 1e-5 / atol 1e-5: both sides add exact f32 products of
0/1 slab values and bf16- or f32-valued features in f32; only the order
of the sums differs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gnnadvisor_osdi21_tpu.ops import spmm_pallas
from gnnadvisor_osdi21_tpu.ops.spmm_pallas import _unpack_tile_t
from gnnadvisor_osdi21_tpu_torch.bench import fixprobe, stepprobe
from gnnadvisor_osdi21_tpu_torch.graphs import hybrid
from gnnadvisor_osdi21_tpu_torch.ops import probe_cuda

TOL = dict(rtol=1e-5, atol=1e-5)


# --- copy of gnnadvisor_osdi21_tpu/bench/fixprobe.py:63-119 -----------------
def _bit_t_kernel(bits_ref, shift_ref, xt_ref, out_ref):
    a_t = _unpack_tile_t(bits_ref, shift_ref, xt_ref.dtype)  # [K, TR]
    out_ref[:] = jax.lax.dot_general(
        xt_ref[:], a_t, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )  # [D, TR]


@functools.partial(jax.jit, static_argnames=("br_",))
def bit_slab_t(bits_t, x_t, br_):
    w32, r_ = bits_t.shape
    k_ = w32 * 32
    d_ = x_t.shape[0]
    shift_col = (jnp.arange(k_, dtype=jnp.uint32) // jnp.uint32(w32))[:, None]
    return pl.pallas_call(
        _bit_t_kernel,
        out_shape=jax.ShapeDtypeStruct((d_, r_), jnp.float32),
        grid_spec=pl.GridSpec(
            grid=(r_ // br_,),
            in_specs=[
                pl.BlockSpec((w32, br_), lambda i: (0, i),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((k_, 1), lambda i: (0, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((d_, k_), lambda i: (0, 0),
                             memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((d_, br_), lambda i: (0, i),
                                   memory_space=pltpu.VMEM),
        ),
        interpret=True,
    )(bits_t, shift_col, x_t)


def _i8_t_kernel(a_ref, xt_ref, out_ref):
    a = a_ref[:].astype(xt_ref.dtype)
    out_ref[:] = jax.lax.dot_general(
        xt_ref[:], a, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )


@functools.partial(jax.jit, static_argnames=("br_",))
def i8_slab_t(a_t, x_t, br_):
    k_, r_ = a_t.shape
    d_ = x_t.shape[0]
    return pl.pallas_call(
        _i8_t_kernel,
        out_shape=jax.ShapeDtypeStruct((d_, r_), jnp.float32),
        grid_spec=pl.GridSpec(
            grid=(r_ // br_,),
            in_specs=[
                pl.BlockSpec((k_, br_), lambda i: (0, i),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((d_, k_), lambda i: (0, 0),
                             memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((d_, br_), lambda i: (0, i),
                                   memory_space=pltpu.VMEM),
        ),
        interpret=True,
    )(a_t, x_t)


# --- copy of gnnadvisor_osdi21_tpu/bench/stepprobe.py:69-97 -----------------
def _dense_kernel(a_ref, x_ref, o_ref):
    a = a_ref[:]
    if a.dtype != x_ref.dtype:
        a = a.astype(x_ref.dtype)
    o_ref[:] = jax.lax.dot_general(
        a, x_ref[:], (((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )


@functools.partial(jax.jit, static_argnames=("br",))
def dense_slab(a_t, x, br):
    k_, r_ = a_t.shape
    d_ = x.shape[1]
    return pl.pallas_call(
        _dense_kernel,
        out_shape=jax.ShapeDtypeStruct((r_, d_), jnp.float32),
        grid_spec=pl.GridSpec(
            grid=(r_ // br,),
            in_specs=[
                pl.BlockSpec((k_, br), lambda i: (0, i),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((k_, d_), lambda i: (0, 0),
                             memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((br, d_), lambda i: (i, 0),
                                   memory_space=pltpu.VMEM),
        ),
        interpret=True,
    )(a_t, x)


# ---------------------------------------------------------------------------


def _edges(seed: int, r: int, k: int):
    """8·R random (row, column) pairs, as the probe scripts draw them."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, r, size=8 * r), rng.integers(0, k, size=8 * r)


def _dense01(rows, cols, k, r):
    a = np.zeros((k, r), dtype=np.int8)
    a[cols, rows] = 1
    return a


def _both(x: np.ndarray, dtype: str):
    """The same values for both sides: bf16 rounds the same way in each."""
    j = jnp.asarray(x).astype(dtype)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    np.testing.assert_array_equal(
        np.asarray(j, dtype=np.float32), t.float().numpy()
    )
    return j, t


def _hard_words_t(slab: str, r: int, w32: int, rng) -> np.ndarray:
    """A bit-major uint32 bit slab [W32, R] that a walk over set bits could
    get wrong: every bit set, bit 31 in every word, or random bits with
    every third graph row and rows 256-767 (whole 128-row tiles) empty."""
    if slab == "every bit set":
        return np.full((w32, r), 0xFFFFFFFF, np.uint32)
    if slab == "bit 31 in every word":
        return np.full((w32, r), 1 << 31, np.uint32)
    words = rng.integers(0, 1 << 32, (w32, r), dtype=np.uint64).astype(
        np.uint32) & rng.integers(0, 1 << 32, (w32, r), dtype=np.uint64
                                  ).astype(np.uint32)
    words[:, ::3] = 0
    words[:, 256:768] = 0
    return words


# K = 64 and up puts more than one word in a row (W32 > 1): the bit order
# column j -> word j % W32, bit j // W32 is what the test pins.  The other
# slabs are the ones a walk over set bits could get wrong (at K = 128, W32 =
# 4: a stage of the card's walk only partly filled); their features are
# dyadic, so that both sides are exact whatever the order of the sums.
@pytest.mark.parametrize("k, slab", [
    pytest.param(64, "random", id="64"), pytest.param(128, "random", id="128"),
    pytest.param(256, "random", id="256"),
    *(pytest.param(k, s, id=f"{k}-{s}")
      for s in ("every bit set", "bit 31 in every word", "empty rows")
      for k in (128, 256)),
])
def test_bit_slab_t_matches_jax(k, slab):
    r = 1024
    rng = np.random.default_rng(k + 1)
    if slab == "random":
        rows, cols = _edges(k, r, k)
        bits = np.ascontiguousarray(hybrid.pack_slab_bits(rows, cols, r, k).T)
        x = rng.standard_normal((16, k)).astype(np.float32)
    else:
        bits = _hard_words_t(slab, r, k // 32, rng)
        x = (rng.integers(-8, 9, (16, k)) / 4).astype(np.float32)
    xj, xt = _both(x, "bfloat16")
    want = np.asarray(bit_slab_t(jnp.asarray(bits), xj, br_=512))
    got = probe_cuda.bit_slab_t(torch.from_numpy(bits), xt).numpy()
    if slab == "random":
        np.testing.assert_allclose(got, want, **TOL)
        # the dense product over the same edges, as a third opinion
        a = _dense01(rows, cols, k, r).astype(np.float32)
        np.testing.assert_allclose(want, xt.float().numpy() @ a, **TOL)
    else:
        # the dense product over the same bits (numpy's own unpacking,
        # independent of the port's), as a third opinion
        j = np.arange(k)
        a = ((bits[j % (k // 32)] >> (j // (k // 32)).astype(np.uint32)[:, None])
             & 1).astype(np.float32)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, xt.float().numpy() @ a)


@pytest.mark.parametrize("k", (64, 128, 256))
def test_i8_slab_t_matches_jax(k):
    r = 1024
    a = _dense01(*_edges(10 + k, r, k), k, r)
    xj, xt = _both(
        np.random.default_rng(k + 2).standard_normal((16, k)).astype(np.float32),
        "bfloat16",
    )
    want = np.asarray(i8_slab_t(jnp.asarray(a), xj, br_=512))
    got = probe_cuda.i8_slab_t(torch.from_numpy(a), xt)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("slab, feat", (
    ("int8", "bfloat16"), ("bfloat16", "bfloat16"), ("int8", "float32"),
))
@pytest.mark.parametrize("k", (64, 256))
def test_dense_slab_matches_jax(k, slab, feat):
    r = 2048
    a = _dense01(*_edges(20 + k, r, k), k, r)
    aj = jnp.asarray(a).astype(slab)
    at = torch.from_numpy(a).to(getattr(torch, slab))
    xj, xt = _both(
        np.random.default_rng(k + 3).standard_normal((k, 16)).astype(np.float32),
        feat,
    )
    want = np.asarray(dense_slab(aj, xj, br=512))
    got = probe_cuda.dense_slab(at, xt)
    assert got.shape == (r, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# The JAX kernels cast any int8 slab value, not only 0/1: so do the port's.
@pytest.mark.parametrize("kernel", ("i8_slab_t", "dense_slab"))
def test_dense_slabs_take_every_int8_value_like_jax(kernel):
    k, r = 128, 1024
    a = np.random.default_rng(50).integers(-128, 128, (k, r)).astype(np.int8)
    if kernel == "i8_slab_t":
        xj, xt = _both(np.random.default_rng(51).standard_normal(
            (16, k)).astype(np.float32), "bfloat16")
        want = np.asarray(i8_slab_t(jnp.asarray(a), xj, br_=512))
        got = probe_cuda.i8_slab_t(torch.from_numpy(a), xt)
    else:
        xj, xt = _both(np.random.default_rng(52).standard_normal(
            (k, 16)).astype(np.float32), "float32")
        want = np.asarray(dense_slab(jnp.asarray(a), xj, br=512))
        got = probe_cuda.dense_slab(torch.from_numpy(a), xt)
    # sums of 128 products up to 128·|x|: 1e-5 relative to the terms' sum
    scale = np.abs(a).astype(np.float32).sum(0).max() * 4
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * scale)


# --- the dense kernels' arithmetic (csrc/dense_slab.cu), emulated ------------


def _prmt(a, b, sel: int):
    """PTX prmt.b32 in its default mode on uint32 arrays: result byte i is
    byte (sel >> 4i) & 7 of the eight bytes [a, b]."""
    src = [(a >> (8 * i)) & 0xFF for i in range(4)] + \
        [(b >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4)).astype(
        np.uint32)


def _bf16_halves(w):
    """The two bf16 of a uint32 pair as f32 (low half first)."""
    return ((w << 16).astype(np.uint32).view(np.float32),
            (w & 0xFFFF0000).astype(np.uint32).view(np.float32))


def _add_bf16x2(x, y):
    """fma.rn.bf16x2 x·1 + y, for sums that are exact in bf16 (asserted)."""
    out = np.zeros_like(x)
    for shift, (p, q) in zip((0, 16), zip(_bf16_halves(x), _bf16_halves(y))):
        bits = (p + q).astype(np.float32).view(np.uint32)
        assert not (bits & 0xFFFF).any(), "the sum is not exact in bf16"
        out |= ((bits >> 16) << shift).astype(np.uint32)
    return out


def _i8x4_to_bf16x2(p):
    """The kernel's i8x4_to_bf16x2: bytes [b0, b1, b2, b3] -> the bf16
    pairs (b0, b1) and (b2, b3), as 0x4300 | l plus 0xC300 | s << 7."""
    lo7, sign = p & np.uint32(0x7F7F7F7F), p & np.uint32(0x80808080)
    c, n = np.uint32(0x43434343), np.uint32(0xC3C3C3C3)
    return (_add_bf16x2(_prmt(lo7, c, 0x4140), _prmt(sign, n, 0x4140)),
            _add_bf16x2(_prmt(lo7, c, 0x4342), _prmt(sign, n, 0x4342)))


def test_int8_to_bf16_without_i2f_is_the_cast_for_every_value():
    """The kernel's int8 -> bf16 path (Frag<kInt8>::build: the interleave
    of two slab rows, then the permutes and one bf16x2 FMA) gives, bit for
    bit, torch's int8 -> bf16 cast of all 256 int8 values."""
    vals = np.arange(-128, 128).astype(np.int8)
    u = vals.view(np.uint32)  # 64 words of four values
    v = np.roll(vals, 1).view(np.uint32)  # the next slab row
    cast = torch.from_numpy(vals).to(torch.bfloat16).view(torch.int16)
    cast = cast.numpy().view(np.uint16).astype(np.uint32)
    cast_v = np.roll(cast, 1)
    got = np.zeros((64, 4), np.uint32)
    got_v = np.zeros((64, 4), np.uint32)
    # [u.b0, v.b0, u.b1, v.b1] and [u.b2, v.b2, u.b3, v.b3]
    for sel, bytes_ in ((0x5140, (0, 1)), (0x7362, (2, 3))):
        for pair, byte in zip(_i8x4_to_bf16x2(_prmt(u, v, sel)), bytes_):
            got[:, byte], got_v[:, byte] = pair & 0xFFFF, pair >> 16
    np.testing.assert_array_equal(got.reshape(-1), cast)
    np.testing.assert_array_equal(got_v.reshape(-1), cast_v)


def _split3(x: np.ndarray):
    """The kernel's split3: f32 x -> bf16 bits (hi, mid, lo), each the top
    16 bits of what is left."""
    top = np.uint32(0xFFFF0000)
    hi = (x.view(np.uint32) & top).view(np.float32)
    r1 = (x - hi).astype(np.float32)
    mid = (r1.view(np.uint32) & top).view(np.float32)
    r2 = (r1 - mid).astype(np.float32)
    return hi, mid, r2, (r2.view(np.uint32) & top).view(np.float32)


def test_f32_split_into_three_bf16_terms_is_exact():
    """hi + mid + lo == x exactly for ±0 and every normal |x| >= 2^-103
    (then each term is a normal bf16 of at most 8 significant bits): so
    the int8/f32 pair runs on the bf16 tensor cores with no rounding of
    the features."""
    rng = np.random.default_rng(60)
    normal = rng.standard_normal(4096) * 10.0 ** rng.uniform(-30, 30, 4096)
    edges = [0.0, -0.0, 1e30, -1e30, 1e-30, -1e-30, 3.3e38, 2.0 ** -103,
             -(2.0 ** -103) * (2 - 2.0 ** -23), np.nextafter(1e30, 2e30),
             np.nextafter(1e-30, 0.0)]
    x = np.concatenate([normal, edges, rng.standard_normal(4096)]).astype(
        np.float32)
    hi, mid, r2, lo = _split3(x)
    np.testing.assert_array_equal(lo, r2)  # the last term is a whole bf16
    for t in (hi, mid, lo):  # each is a bf16 value
        assert not (t.view(np.uint32) & 0xFFFF).any()
    total = hi.astype(np.float64) + mid.astype(np.float64) + lo.astype(
        np.float64)
    np.testing.assert_array_equal(total, x.astype(np.float64))


# --- the slab builders -------------------------------------------------------


@pytest.mark.parametrize("k", (32, 64, 256))
def test_pack_slab_bits_matches_jax(k):
    rows, cols = _edges(30 + k, 700, k)
    want = spmm_pallas.pack_slab_bits(rows, cols, 700, k)
    got = hybrid.pack_slab_bits(rows, cols, 700, k)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", (32, 64, 256))
def test_transpose_slab_matches_jax(k):
    rows, cols = _edges(40 + k, 700, k)
    bits = spmm_pallas.pack_slab_bits(rows, cols, 700, k)
    want = spmm_pallas.transpose_slab(bits)
    got = hybrid.transpose_slab(bits)
    assert got.dtype == want.dtype == np.uint16 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # stepprobe builds its slabs with pack_slab_bits_t: the same bytes
    np.testing.assert_array_equal(
        hybrid.pack_slab_bits_t(rows, cols, 700, k), want
    )


def test_unpack_bits32_is_the_bit_major_layout():
    """Column j of a uint32 slab: word j % W32, bit j // W32 (W32 = 4)."""
    k, r = 128, 3
    rows = np.array([0, 1, 2, 2])
    cols = np.array([5, 127, 0, 64])
    bits = np.ascontiguousarray(hybrid.pack_slab_bits(rows, cols, r, k).T)
    dense = probe_cuda.unpack_bits32(torch.from_numpy(bits)).numpy()
    want = np.zeros((k, r), np.float32)
    want[cols, rows] = 1
    np.testing.assert_array_equal(dense, want)


# --- the wrappers -------------------------------------------------------------


def test_block_rows_follow_the_tpu_sweep():
    assert [probe_cuda.block_rows_for(b) for b in (512, 1024, 2048, 4096, 8192)] \
        == [32, 64, 128, 256, 512]


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports a CUDA device: enough to steer dispatch."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda_typed(t: torch.Tensor) -> torch.Tensor:
    return torch.Tensor._make_subclass(_CudaTyped, t)


@pytest.mark.parametrize("kernel", probe_cuda.KERNELS)
def test_cuda_tensors_never_reach_the_plain_version(kernel, monkeypatch):
    launched = []

    def plain(*args, **kwargs):
        raise AssertionError(f"{kernel}: CUDA operands reached the plain version")

    for name in probe_cuda.KERNELS:
        monkeypatch.setattr(probe_cuda, f"{name}_plain", plain)
        monkeypatch.setattr(
            probe_cuda, f"_{name}_cuda",
            lambda *a, _n=name: launched.append(_n) or "launched",
        )
    x_t = _cuda_typed(torch.zeros((16, 64), dtype=torch.bfloat16))
    if kernel == "bit_slab_t":
        bits = _cuda_typed(torch.zeros((2, 512), dtype=torch.uint32))
        got = probe_cuda.bit_slab_t(bits, x_t)
    elif kernel == "i8_slab_t":
        a = _cuda_typed(torch.zeros((64, 512), dtype=torch.int8))
        got = probe_cuda.i8_slab_t(a, x_t)
    else:
        a = _cuda_typed(torch.zeros((64, 512), dtype=torch.int8))
        x = _cuda_typed(torch.zeros((64, 16), dtype=torch.float32))
        got = probe_cuda.dense_slab(a, x)
    assert got == "launched" and launched == [kernel]


@pytest.mark.parametrize("case", ("width", "k", "block", "dtype_pair"))
def test_cuda_launches_check_their_shapes(case, monkeypatch):
    """What the CUDA kernels cannot take raises before any launch."""
    monkeypatch.setattr(probe_cuda, "_dense_slab_cuda",
                        lambda *a: pytest.fail("launched"))
    a = _cuda_typed(torch.zeros((64, 512), dtype=torch.int8))
    x = _cuda_typed(torch.zeros((64, 16), dtype=torch.bfloat16))
    kwargs = {}
    if case == "width":
        x = _cuda_typed(torch.zeros((64, 8), dtype=torch.bfloat16))
    elif case == "k":  # K must be a multiple of the MMA's k16 step
        a = _cuda_typed(torch.zeros((40, 512), dtype=torch.int8))
        x = _cuda_typed(torch.zeros((40, 16), dtype=torch.bfloat16))
    elif case == "block":
        kwargs["block_rows"] = 48
    else:
        a = _cuda_typed(torch.zeros((64, 512), dtype=torch.bfloat16))
        x = _cuda_typed(torch.zeros((64, 16), dtype=torch.float32))
    with pytest.raises(ValueError):
        probe_cuda.dense_slab(a, x, **kwargs)


@pytest.mark.parametrize("case", ("rows", "block", "width"))
def test_bit_slab_t_launch_checks_its_shapes(case, monkeypatch):
    """What the set-bit walk cannot take raises before any launch: R not a
    multiple of 8 (the slab's tensor-map rows), a block_rows outside the
    scripts' sweep, features other than 16 wide."""
    monkeypatch.setattr(probe_cuda, "_bit_slab_t_cuda",
                        lambda *a: pytest.fail("launched"))
    r, d, kwargs = 512, 16, {}
    if case == "rows":
        r = 516
    elif case == "block":
        kwargs["block_rows"] = 48
    else:
        d = 8
    bits = _cuda_typed(torch.zeros((2, r), dtype=torch.uint32))
    x_t = _cuda_typed(torch.zeros((d, 64), dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        probe_cuda.bit_slab_t(bits, x_t, **kwargs)


# --- the probe scripts, rehearsed on the CPU at a small R ---------------------


@pytest.mark.parametrize("script, lines", (
    # bitT: 3 + 3 + 2 + 1 + 0 lines, i8T: 2 + 2 + 2 + 2 + 1, 2 gathers
    (fixprobe, 20),
    # hot slab: (12 + 12 + 12 + 8) lines and a header; dense: 27 and a header
    (stepprobe, 73),
))
def test_probe_scripts_keep_the_jax_sweeps(script, lines, capsys):
    """Each script runs to its end off the card (plain versions) and prints
    one line per point of the JAX script's sweep, skip rules included."""
    assert script.main(["--rows", "2048", "--iters", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == lines, out
    assert all("host" in line for line in out if not line.startswith("=="))
