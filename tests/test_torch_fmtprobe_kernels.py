"""The format probe's kernels: their plain versions (reached through the
port's wrappers on CPU tensors) against the JAX package's Pallas kernels in
interpret mode, on the same numpy inputs; the wrappers' dispatch and shape
checks; and the port's ``bench/fmtprobe.py`` run to its end off the card.

The JAX kernels are defined inside ``fmtprobe.py``'s ``main()`` and cannot
be imported, so this file carries copies of them: each kernel body and its
``pallas_call`` wrapper as written there, with ``interpret=True`` added to
the ``pallas_call`` (the only change); the script's closure variables (r,
k, d, TILE, OB, ...) become the arguments of a factory.

Tolerances:

- integer-valued or dyadic inputs (values k/4, small k) match exactly:
  every product and every partial sum is exact in f32 on both sides;
- ``stream_sum`` over random f32 (uniform in [0, 1), so no cancellation):
  rtol 1e-5, the two sides' summation orders;
- ``i8_slab`` and ``bit_slab`` over random features: rtol and atol 1e-5
  (exact products, f32 summation order only);
- ``seg_reduce`` over unit-normal values: per output element, atol
  2^-7 · (the segment sum of |v|): the fold's f32 sum of eight bf16 lanes
  may round to the neighbouring bf16 in another summation order, which
  moves each slot's v by at most 2^-8 of its size.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gnnadvisor_osdi21_tpu_torch.bench import fmtprobe
from gnnadvisor_osdi21_tpu_torch.graphs import hybrid
from gnnadvisor_osdi21_tpu_torch.ops import fmtprobe_cuda

TOL = dict(rtol=1e-5, atol=1e-5)


# --- copy of gnnadvisor_osdi21_tpu/bench/fmtprobe.py:53-77 -------------------
def _sum_kernel(a_ref, s_ref, o_ref):
    # s_ref varies per timing iteration: forces re-execution (a
    # constant-input call would be hoisted out of the fori_loop)
    a = a_ref[:]
    if a.dtype == jnp.uint32:
        a = a.astype(jnp.int32)
    o_ref[:] = jnp.sum(a.astype(jnp.float32)) + s_ref[:]


def stream(a, s, block):
    g = a.shape[0] // block
    return pl.pallas_call(
        _sum_kernel,
        out_shape=jax.ShapeDtypeStruct((g * 8, 128), jnp.float32),
        grid_spec=pl.GridSpec(
            grid=(g,),
            in_specs=[
                pl.BlockSpec((block, a.shape[1]), lambda i: (i, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((8, 128), lambda i: (0, 0),
                             memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((8, 128), lambda i: (i, 0),
                                   memory_space=pltpu.VMEM),
        ),
        interpret=True,
    )(a, s)


# --- copy of fmtprobe.py:118-141 ---------------------------------------------
def _i8_kernel(a_ref, x_ref, o_ref):
    o_ref[:] = jnp.dot(a_ref[:].astype(jnp.bfloat16), x_ref[:],
                       preferred_element_type=jnp.float32)


def make_i8_slab(r, k, d):
    @functools.partial(jax.jit, static_argnames=("block",))
    def i8_slab(a, x, block=512):
        return pl.pallas_call(
            _i8_kernel,
            out_shape=jax.ShapeDtypeStruct((r, d), jnp.float32),
            grid_spec=pl.GridSpec(
                grid=(r // block,),
                in_specs=[
                    pl.BlockSpec((block, k), lambda i: (i, 0),
                                 memory_space=pltpu.VMEM),
                    pl.BlockSpec((k, d), lambda i: (0, 0),
                                 memory_space=pltpu.VMEM),
                ],
                out_specs=pl.BlockSpec((block, d), lambda i: (i, 0),
                                       memory_space=pltpu.VMEM),
            ),
            cost_estimate=pl.CostEstimate(
                flops=2 * r * k * d, bytes_accessed=r * k + k * d * 2 + r * d * 4,
                transcendentals=0),
            interpret=True,
        )(a, x.astype(jnp.bfloat16))

    return i8_slab


# --- copy of fmtprobe.py:213-252 ---------------------------------------------
def make_mk_slab(r, k, d):
    w32 = k // 32

    def mk_slab(variant, block):
        def kern(bits_ref, aux_ref, xh_ref, out_ref):
            words = pltpu.repeat(bits_ref[:], 32, axis=1)
            if variant == "base_bf16":
                bit = (words >> aux_ref[:]) & 1
                a = pltpu.bitcast(bit * jnp.uint32(0x3F800000),
                                  jnp.float32).astype(jnp.bfloat16)
                out_ref[:] = jnp.dot(a, xh_ref[:],
                                     preferred_element_type=jnp.float32)
            elif variant == "mul_f32dot":
                bit = (words >> aux_ref[:]) & 1
                a = pltpu.bitcast(bit * jnp.uint32(0x3F800000), jnp.float32)
                out_ref[:] = jnp.dot(a, xh_ref[:].astype(jnp.float32),
                                     preferred_element_type=jnp.float32)

        aux = (jnp.arange(k, dtype=jnp.uint32)
               // jnp.uint32(w32))[None, :]

        @jax.jit
        def call(bits_, xh_):
            return pl.pallas_call(
                kern,
                out_shape=jax.ShapeDtypeStruct((r, d), jnp.float32),
                grid_spec=pl.GridSpec(
                    grid=(r // block,),
                    in_specs=[
                        pl.BlockSpec((block, w32), lambda i: (i, 0),
                                     memory_space=pltpu.VMEM),
                        pl.BlockSpec((1, k), lambda i: (0, 0),
                                     memory_space=pltpu.VMEM),
                        pl.BlockSpec((k, d), lambda i: (0, 0),
                                     memory_space=pltpu.VMEM),
                    ],
                    out_specs=pl.BlockSpec((block, d), lambda i: (i, 0),
                                          memory_space=pltpu.VMEM),
                ),
                interpret=True,
            )(bits_, aux, xh_ if variant == "mul_f32dot"
              else xh_.astype(jnp.bfloat16))

        return call

    return mk_slab


# --- copy of fmtprobe.py:287-339 ---------------------------------------------
def make_segred(d, TILE, OB, t_total, n_blocks):
    def _seg_kernel(t2b_ref, first_ref, vals_ref, mask_ref, seg_ref,
                    s_ref, out_ref):
        t = pl.program_id(0)
        group = (jax.lax.broadcasted_iota(jnp.uint32, (1, 128), 1)
                 // jnp.uint32(d))
        mm = pltpu.bitcast(
            ((mask_ref[:] >> group) & 1) * jnp.uint32(0x3F800000),
            jnp.float32)
        vm = (vals_ref[:] * mm).astype(jnp.bfloat16)
        # lane-group fold c*D -> D via a tiny matmul (Mosaic cannot
        # reshape across the lane dimension)
        li = jax.lax.broadcasted_iota(jnp.int32, (128, d), 0)
        di = jax.lax.broadcasted_iota(jnp.int32, (128, d), 1)
        rmat = (li % d == di).astype(jnp.bfloat16)
        v = jnp.dot(vm, rmat, preferred_element_type=jnp.float32)
        iota = jax.lax.broadcasted_iota(jnp.int32, (TILE, OB), 1)
        onehot = (seg_ref[:] == iota).astype(jnp.bfloat16)
        part = jax.lax.dot_general(
            onehot, v.astype(jnp.bfloat16),
            dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32) + s_ref[0, 0]

        @pl.when(first_ref[t] == 1)
        def _():
            out_ref[:] = part

        @pl.when(first_ref[t] != 1)
        def _():
            out_ref[:] += part

    @jax.jit
    def segred(vals, masks, segs, t2b, first, s):
        grid_spec = pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=2,
            grid=(t_total,),
            in_specs=[
                pl.BlockSpec((TILE, 128), lambda t, t2b, fr: (t, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((TILE, 1), lambda t, t2b, fr: (t, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((TILE, 1), lambda t, t2b, fr: (t, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((8, 128), lambda t, t2b, fr: (0, 0),
                             memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((OB, d), lambda t, t2b, fr: (t2b[t], 0),
                                   memory_space=pltpu.VMEM),
        )
        return pl.pallas_call(
            _seg_kernel,
            out_shape=jax.ShapeDtypeStruct((n_blocks * OB, d), jnp.float32),
            grid_spec=grid_spec,
            interpret=True,
        )(t2b, first, vals, masks, segs, s)

    return segred


# ---------------------------------------------------------------------------


def _both(x: np.ndarray, dtype: str):
    """The same values for both sides: bf16 rounds the same way in each."""
    j = jnp.asarray(x).astype(dtype)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    np.testing.assert_array_equal(
        np.asarray(j, dtype=np.float32), t.float().numpy()
    )
    return j, t


def _features(rng, k, d, kind):
    """Unit normal, or dyadic (k/4 for small k): exact products and sums."""
    if kind == "dyadic":
        return (rng.integers(-8, 9, (k, d)) / 4).astype(np.float32)
    return rng.standard_normal((k, d)).astype(np.float32)


# --- B.7 stream_sum ------------------------------------------------------------


def _stream_input(kind, rng, r, k):
    if kind == "int8":
        return rng.integers(-128, 128, (r, k)).astype(np.int8), True
    if kind == "f32 dyadic":
        return (rng.integers(-64, 65, (r, k)) / 4).astype(np.float32), True
    if kind == "f32 random":
        return rng.random((r, k), dtype=np.float32), False
    # u32: multiples of 2^24, half of them 2^31 or more (negative as int32);
    # each word and every partial sum is exact in f32
    return (rng.integers(0, 256, (r, k)).astype(np.uint32) << np.uint32(24)), True


@pytest.mark.parametrize("block", (512, 256))
@pytest.mark.parametrize("kind", ("int8", "f32 dyadic", "f32 random", "u32"))
def test_stream_sum_matches_jax(kind, block):
    rng = np.random.default_rng(len(kind) + block)
    r, k = 1024, 128
    a, exact = _stream_input(kind, rng, r, k)
    if kind == "u32":
        assert (a >= 2**31).any()
    s = rng.integers(-4, 5, (8, 128)).astype(np.float32)
    want = np.asarray(stream(jnp.asarray(a), jnp.asarray(s), block))
    got = fmtprobe_cuda.stream_sum(torch.from_numpy(a), torch.from_numpy(s),
                                   block).numpy()
    assert got.shape == want.shape == (8 * (r // block), 128)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5)


# --- B.8 i8_slab -----------------------------------------------------------------


# every int8 value takes dyadic features only, whose products (up to 2^8)
# and sums are exact on both sides
@pytest.mark.parametrize("block, slab, feat", [
    *(pytest.param(b, s, f, id=f"{b}-{s}-{f}")
      for b in (512, 1024) for s in ("random 0/1", "all ones")
      for f in ("normal", "dyadic")),
    *(pytest.param(b, "every int8 value", "dyadic",
                   id=f"{b}-every int8 value-dyadic") for b in (512, 1024)),
])
def test_i8_slab_matches_jax(block, slab, feat):
    rng = np.random.default_rng(block + len(slab) + len(feat))
    r, k, d = 2048, 128, 16
    if slab == "every int8 value":  # each pair of rows, in random orders
        a = np.empty((r, k), np.int8)
        a[0::2], a[1::2] = np.arange(-128, 0), np.arange(0, 128)
        a = rng.permuted(a, axis=1)
    else:
        a = (rng.integers(0, 2, (r, k)) if slab == "random 0/1"
             else np.ones((r, k))).astype(np.int8)
    x = _features(rng, k, d, feat)
    want = np.asarray(make_i8_slab(r, k, d)(jnp.asarray(a), jnp.asarray(x),
                                            block=block))
    got = fmtprobe_cuda.i8_slab(torch.from_numpy(a), torch.from_numpy(x),
                                block).numpy()
    assert got.shape == (r, d) and got.dtype == np.float32
    if feat == "dyadic":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


# --- B.9 bit_slab ------------------------------------------------------------------


def _hard_words(slab: str, r: int, w32: int, rng) -> np.ndarray:
    """A row-major uint32 bit slab [R, W32] that a walk over set bits could
    get wrong: every bit set, bit 31 in every word, or random bits with
    every third row and rows 256-767 (whole 128-row tiles) empty."""
    if slab == "every bit set":
        return np.full((r, w32), 0xFFFFFFFF, np.uint32)
    if slab == "bit 31 in every word":
        return np.full((r, w32), 1 << 31, np.uint32)
    words = rng.integers(0, 1 << 32, (r, w32), dtype=np.uint64).astype(
        np.uint32) & rng.integers(0, 1 << 32, (r, w32), dtype=np.uint64
                                  ).astype(np.uint32)
    words[::3] = 0
    words[256:768] = 0
    return words


def _dense_of(words: np.ndarray) -> np.ndarray:
    """The 0/1 [R, 32·W32] matrix of a row-major slab (numpy's own
    unpacking, independent of the port's)."""
    r, w32 = words.shape
    j = np.arange(32 * w32)
    return ((words[:, j % w32] >> (j // w32).astype(np.uint32)) & 1).astype(
        np.float32)


# W32 = 2, 4 and 8 put 2 to 8 words in a row: the order column j -> word
# j % W32, bit j // W32 is what the test pins.  The other slabs are the ones
# a walk over set bits could get wrong (at W32 = 4, a stage of the card's
# walk only partly filled); their features are dyadic, so that both sides
# are exact whatever the order of the sums.
@pytest.mark.parametrize("variant", ("base_bf16", "mul_f32dot"))
@pytest.mark.parametrize("w32, slab", [
    pytest.param(2, "random", id="2"), pytest.param(4, "random", id="4"),
    pytest.param(8, "random", id="8"),
    *(pytest.param(w, s, id=f"{w}-{s}")
      for s in ("every bit set", "bit 31 in every word", "empty rows")
      for w in (4, 8)),
])
def test_bit_slab_matches_jax(w32, slab, variant):
    rng = np.random.default_rng(
        w32 + len(variant) + (0 if slab == "random" else len(slab)))
    r, d, k = 1024, 16, 32 * w32
    if slab == "random":
        rows, cols = rng.integers(0, r, 6 * r), rng.integers(0, k, 6 * r)
        bits = hybrid.pack_slab_bits(rows, cols, r, k)
        x = rng.standard_normal((k, d)).astype(np.float32)
    else:
        bits = _hard_words(slab, r, w32, rng)
        x = (rng.integers(-8, 9, (k, d)) / 4).astype(np.float32)
    want = np.asarray(make_mk_slab(r, k, d)(variant, 512)(
        jnp.asarray(bits), jnp.asarray(x)))
    xt = torch.from_numpy(x)
    got = fmtprobe_cuda.bit_slab(
        torch.from_numpy(bits),
        xt.to(torch.bfloat16) if variant == "base_bf16" else xt).numpy()
    # the dense product over the same edges, as a third opinion
    xs = xt.to(torch.bfloat16).float().numpy() if variant == "base_bf16" else x
    if slab == "random":
        np.testing.assert_allclose(got, want, **TOL)
        dense = np.zeros((r, k), np.float32)
        dense[rows, cols] = 1
        np.testing.assert_allclose(got, dense @ xs, **TOL)
    else:
        dense = _dense_of(bits) @ xs
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, dense)


def test_unpack_rows32_is_the_legacy_order():
    """Column j of a row-major uint32 slab: word j % W32, bit j // W32."""
    k, r = 128, 3
    rows = np.array([0, 1, 2, 2])
    cols = np.array([5, 127, 0, 64])
    bits = hybrid.pack_slab_bits(rows, cols, r, k)
    dense = fmtprobe_cuda.unpack_rows32(torch.from_numpy(bits)).numpy()
    want = np.zeros((r, k), np.float32)
    want[rows, cols] = 1
    np.testing.assert_array_equal(dense, want)


# --- B.10 seg_reduce -----------------------------------------------------------------


def _seg_inputs(rng, tile, ob, n_blocks, tiles_per_block, vals_kind,
                shuffled=False):
    """Segment ids per tile, sorted (or, ``shuffled``, in a random order
    within each tile), several tiles per block, the last block without a
    tile, and a first flag that also restarts one block mid-way."""
    covered = n_blocks - 1
    t2b = np.repeat(np.arange(covered, dtype=np.int32), tiles_per_block)
    t_total = len(t2b)
    first = np.ones(t_total, dtype=np.int32)
    first[1:] = t2b[1:] != t2b[:-1]
    first[tiles_per_block + 1] = 1  # block 1 restarts at its second tile
    segs = np.sort(rng.integers(0, ob, (t_total, tile))).astype(np.int32)
    if shuffled:
        segs = rng.permuted(segs, axis=1)
    masks = rng.integers(1, 255, (t_total * tile, 1)).astype(np.uint32)
    if vals_kind == "ones":
        vals = np.ones((t_total * tile, 128), np.float32)
    else:
        vals = rng.standard_normal((t_total * tile, 128)).astype(np.float32)
    s = np.zeros((8, 128), np.float32)
    s[0, 0] = 0.25
    return (vals, masks, segs.reshape(-1, 1), t2b, first, s), covered


# segment ids sorted within each tile (the fast case on the card), and
# shuffled within each tile
@pytest.mark.parametrize("tile, ob, vals_kind, order", [
    *(pytest.param(t, o, v, "sorted", id=f"{t}-{o}-{v}")
      for t, o in ((32, 128), (64, 128), (32, 256))
      for v in ("normal", "ones")),
    *(pytest.param(t, o, v, "shuffled", id=f"{t}-{o}-{v}-shuffled")
      for t, o in ((32, 128), (64, 256)) for v in ("normal", "ones")),
])
def test_seg_reduce_matches_jax(tile, ob, vals_kind, order):
    rng = np.random.default_rng(tile + ob + len(vals_kind) + len(order) - 6)
    d, n_blocks, per_block = 16, 4, 3
    args, covered = _seg_inputs(rng, tile, ob, n_blocks, per_block, vals_kind,
                                order == "shuffled")
    vals, masks, segs, t2b, first, s = args
    segred = make_segred(d, tile, ob, len(t2b), n_blocks)
    want = np.asarray(segred(*map(jnp.asarray, args)))[: covered * ob]
    targs = [torch.from_numpy(a) for a in args]
    got = fmtprobe_cuda.seg_reduce(*targs, tile, ob, n_blocks).numpy()
    assert got.shape == (n_blocks * ob, d)
    # the block no tile maps to is zeros (Pallas leaves it unwritten)
    np.testing.assert_array_equal(got[covered * ob:], 0)
    got = got[: covered * ob]
    if vals_kind == "ones":
        np.testing.assert_array_equal(got, want)
        return
    abs_v = fmtprobe_cuda.seg_reduce_plain(
        torch.from_numpy(np.abs(vals)), *targs[1:5],
        torch.zeros((8, 128)), tile, ob, n_blocks).numpy()[: covered * ob]
    np.testing.assert_array_less(np.abs(got - want), 2.0 ** -7 * abs_v + 1e-6)


# --- the wrappers -----------------------------------------------------------------


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports a CUDA device: enough to steer dispatch."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda(t: torch.Tensor) -> torch.Tensor:
    return torch.Tensor._make_subclass(_CudaTyped, t)


def _call(kernel, **over):
    """One call of ``kernel`` on CUDA-typed operands of valid shapes;
    ``over`` replaces an operand or argument."""
    z = torch.zeros
    if kernel == "stream_sum":
        kw = dict(a=z((1024, 64), dtype=torch.int8), s=z((8, 128)), block=512)
    elif kernel == "i8_slab":
        kw = dict(a=z((512, 64), dtype=torch.int8),
                  x=z((64, 16), dtype=torch.bfloat16), block_rows=512)
    elif kernel == "bit_slab":
        kw = dict(bits=z((512, 4), dtype=torch.uint32), x=z((128, 16)),
                  block_rows=512)
    else:
        kw = dict(vals=z((64, 128)), masks=z((64, 1), dtype=torch.uint32),
                  segs=z((64, 1), dtype=torch.int32),
                  t2b=z(2, dtype=torch.int32), first=z(2, dtype=torch.int32),
                  s=z((8, 128)), tile=32, ob=128, n_blocks=2)
    kw.update(over)
    kw = {n: _cuda(v) if isinstance(v, torch.Tensor) else v
          for n, v in kw.items()}
    return getattr(fmtprobe_cuda, kernel)(**kw)


@pytest.mark.parametrize("kernel", fmtprobe_cuda.KERNELS)
def test_cuda_tensors_never_reach_the_plain_version(kernel, monkeypatch):
    launched = []

    def plain(*args, **kwargs):
        raise AssertionError(f"{kernel}: CUDA operands reached the plain version")

    for name in fmtprobe_cuda.KERNELS:
        monkeypatch.setattr(fmtprobe_cuda, f"{name}_plain", plain)
        monkeypatch.setattr(
            fmtprobe_cuda, f"_{name}_cuda",
            lambda *a, _n=name: launched.append(_n) or "launched",
        )
    assert _call(kernel) == "launched" and launched == [kernel]


@pytest.mark.parametrize("kernel, over", (
    ("stream_sum", dict(a=torch.zeros((1024, 3), dtype=torch.int8),
                        block=100)),
    ("stream_sum", dict(s=torch.zeros((8, 64)))),
    ("i8_slab", dict(a=torch.zeros((512, 48), dtype=torch.int8),
                     x=torch.zeros((48, 16), dtype=torch.bfloat16))),
    ("i8_slab", dict(block_rows=384)),
    ("bit_slab", dict(bits=torch.zeros((512, 2), dtype=torch.uint32),
                      x=torch.zeros((64, 16)))),
    ("bit_slab", dict(x=torch.zeros((128, 8)))),
    ("seg_reduce", dict(ob=384)),
    ("seg_reduce", dict(tile=24, vals=torch.zeros((48, 128)),
                        masks=torch.zeros((48, 1), dtype=torch.uint32),
                        segs=torch.zeros((48, 1), dtype=torch.int32))),
    # the ring's bulk copies take masks and ids 16-byte aligned
    ("seg_reduce", dict(masks=torch.zeros((65, 1), dtype=torch.uint32)[1:])),
    ("seg_reduce", dict(segs=torch.zeros((65, 1), dtype=torch.int32)[1:])),
))
def test_cuda_launches_check_their_shapes(kernel, over, monkeypatch):
    """What the CUDA kernels cannot take raises before any launch."""
    for name in fmtprobe_cuda.KERNELS:
        monkeypatch.setattr(fmtprobe_cuda, f"_{name}_cuda",
                            lambda *a: pytest.fail("launched"))
    with pytest.raises(ValueError):
        _call(kernel, **over)


# --- the probe script, rehearsed on the CPU at a small R -----------------------


@pytest.mark.parametrize("section, lines", (
    ("stream", 3), ("slab", 3), ("gather", 3), ("xlares", 2), ("slabvar", 4),
    ("segred", 5), ("", 20),
))
def test_fmtprobe_runs_every_section(section, lines, capsys):
    """The script runs to its end off the card (plain versions) and prints
    one line per point of the JAX script's sweep, each with the host's
    issue time and the CUDA block shape."""
    argv = ["--device", "cpu", "--rows", "2048", "--k", "256", "--iters", "1"]
    if section:
        argv += ["--only", section]
    assert fmtprobe.main(argv) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == lines, out
    assert all(" host " in line for line in out)
