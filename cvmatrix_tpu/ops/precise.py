"""``A^T @ B`` contractions: native float64, or an exact int8-slice scheme.

The reference engine (ref ``cvmatrix/cvmatrix.py:1215-1217`` for the fit
products, ``:1001`` for the per-fold downdate products) runs in NumPy
float64, and its test contract demands 1e-8-level agreement.
:func:`contract` is the single entry point for both. Its default
(``mode="auto"`` or ``"native"``) is one ``dot_general`` at
``Precision.HIGHEST``: native float64 on CPU and GPU (cuBLAS DGEMM behind
XLA), and full float32 (never TF32) for float32 engines.

``mode="exact"`` is an Ozaki-scheme contraction instead: slice each operand's
mantissa into exact 6-bit integer chunks (stored as int8), take all
significant chunk-pair products with ``int8 x int8 -> int32`` matmuls (exact
integer arithmetic), and recombine the partial products in float64. The
result carries ~2^-54 relative error, independent of how the backend rounds
float64 products. It is plain ``jax.numpy``/``lax``.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["contract", "ozaki_contract", "outer_accumulate_contract",
           "symmetric_contract"]

# Bits per mantissa slice. Slice values lie in [-2^T_BITS, 2^T_BITS] and fit
# int8; a product of two slices fits 2*T_BITS+1 bits, leaving int32 headroom
# for summing up to 2^(31 - 2*T_BITS - 1) rows exactly.
_T_BITS = 6
# Number of slices: covers T_BITS * N_SLICES = 60 mantissa bits >= 53 (f64).
_N_SLICES = 10
# Max rows per int8 matmul so the int32 accumulation stays exact:
# N * 2^(2*T_BITS) < 2^31  =>  N < 2^18 (with a 2x safety margin).
_MAX_CHUNK = 1 << 17
# Below this row count, same-exponent slice products can additionally be
# group-summed in int32 before the f64 recombination and stay exact:
# N * 2^(2*T_BITS) * N_SLICES < 2^31  =>  N <= 2^15.
_GROUP_CHUNK = 1 << 15


def _mantissa_slices(x: jax.Array, n_slices: int):
    """Split ``x`` (scaled into (-1, 1)) into int8 mantissa slices.

    ``x ~= sum_i slices[i] * 2**(-T_BITS * (i + 1))`` with each slice an exact
    small integer in [-64, 64]. The residual after ``n_slices`` slices is
    below ``2**(-T_BITS * n_slices)`` relative to the pre-scaling column max.

    All arithmetic here is exact in float64 (multiply by a power of two,
    round, subtract), and every op is elementwise. The int8 cast routes
    through float32, which is exact for these small integers.
    """
    out = []
    r = x
    for _ in range(n_slices):
        r = r * (2.0**_T_BITS)
        q = jnp.round(r)
        out.append(q.astype(jnp.float32).astype(jnp.int8))
        r = r - q
    return out


def _pow2(e: jax.Array) -> jax.Array:
    """Exact float64 ``2.0**e`` for int32 ``e`` across the full f64 range.

    Built from float32 ``ldexp`` factors of at most
    2^±126 each — jax's f32 ldexp flushes subnormals, so 2^-127 would be 0
    — multiplied in float64: a product of exact powers of two is exact,
    and chunking covers |e| up to 9 * 126 = 1134 (the entire f64 exponent
    range; beyond it the product over/underflows to inf/0, which is also
    the correct f64 answer for the rescale it feeds).
    """
    rem = e
    out = None
    for _ in range(9):
        h = jnp.clip(rem, -126, 126)
        rem = rem - h
        p = jnp.ldexp(jnp.float32(1.0), h).astype(jnp.float64)
        out = p if out is None else out * p
    return out


def _column_scale(x: jax.Array):
    """Per-column exponent e with |column max| * 2^-e in [0.5, 1).

    The exponent is extracted from a float32 cast of the column max (f32
    frexp uses only s32 bit ops). Columns outside the f32 exponent range
    are first range-reduced with EXACT power-of-two f64 multiplies (a
    saturating clip here would under-estimate e by hundreds and overflow
    the int8 mantissa slices — silently wrong output for f64 data the
    NumPy reference handles exactly). The f64->f32 cast rounds to nearest,
    which can bump a value just below a power of two up to it; since frexp
    maps 2^k to (0.5, k+1) this only ever *over*-estimates e by 0 — and
    slices stay within int8 range either way because scaled values stay
    < 1 + 2^-24.
    """
    absmax = jnp.max(jnp.abs(x), axis=0)
    red = jnp.where(absmax > 0, absmax, 1.0)
    e_adj = jnp.zeros(red.shape, jnp.int32)
    # Bring the magnitude into (2^-64, 2^64): each step multiplies by an
    # exact power of two (no rounding), so the final frexp sees the true
    # mantissa. Covers the whole f64 range incl. subnormals (|e| <= 1074).
    for shift in (512, 256, 128, 64):
        factor = jnp.float64(2.0) ** -shift
        too_big = red >= jnp.float64(2.0) ** shift
        red = jnp.where(too_big, red * factor, red)
        e_adj = e_adj + jnp.where(too_big, shift, 0).astype(jnp.int32)
        too_small = red < factor
        red = jnp.where(too_small, red / factor, red)
        e_adj = e_adj - jnp.where(too_small, shift, 0).astype(jnp.int32)
    _, e = jnp.frexp(red.astype(jnp.float32))
    return e.astype(jnp.int32) + e_adj


def ozaki_contract(
    a: jax.Array,
    b: jax.Array,
    *,
    n_slices: int = _N_SLICES,
    out_dtype: Optional[jnp.dtype] = None,
) -> jax.Array:
    """Compute ``a.T @ b`` (contraction over axis 0) to ~f64 accuracy.

    ``a``: (N, K), ``b``: (N, M), float64 (or float32). Heavy compute runs as
    exact int8 x int8 -> int32 matmuls; recombination is elementwise
    float64.
    """
    if out_dtype is None:
        out_dtype = a.dtype
    n = a.shape[0]
    f64 = jnp.float64
    e_a = _column_scale(a)
    e_b = _column_scale(b)
    a_scaled = a.astype(f64) * _pow2(-e_a)[None, :]
    b_scaled = b.astype(f64) * _pow2(-e_b)[None, :]

    # Significant slice pairs: i + j <= n_slices - 1 (smaller products fall
    # below the f64 target precision). Scanned with ONE compiled int8 matmul
    # in the body instead of unrolling all ~n_slices^2/2 of them — same
    # arithmetic, ~50x less XLA compile work.
    pairs_i, pairs_j = np.array(
        [(i, j) for i in range(n_slices) for j in range(n_slices - i)]
    ).T
    # 2^-T_BITS(i+j+2) are exact powers of two (f64 constants).
    pair_scale = 2.0 ** (-_T_BITS * (pairs_i + pairs_j + 2.0))

    def pair_step(carry, ijs):
        # Slices ride in the carry (loop-invariant): passing them explicitly
        # instead of closing over them keeps the traced body free of captured
        # chunk constants (closure capture + scan's trace cache would reuse
        # the first chunk's data for later same-shape chunks).
        acc, sa, sb = carry
        i, j, sc = ijs
        d = jax.lax.dot_general(
            jax.lax.dynamic_index_in_dim(sa, i, 0, keepdims=False),
            jax.lax.dynamic_index_in_dim(sb, j, 0, keepdims=False),
            (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        return (acc + d.astype(f64) * sc, sa, sb), None

    def group_step(carry, s_scale):
        # Same-exponent group via a scanned fori accumulation: ONE (K, C)
        # int32 buffer lives at a time. The prefix-stack form below is
        # faster but unrolls 10 matmuls whose int32 outputs XLA may keep
        # alive simultaneously — at genomics-wide K a single (20480,
        # 20480) int32 product is 1.7 GB, so large outputs use this form.
        acc, sa, sb = carry
        s, sc = s_scale

        def i_step(i, d32):
            return d32 + jax.lax.dot_general(
                jax.lax.dynamic_index_in_dim(sa, i, 0, keepdims=False),
                jax.lax.dynamic_index_in_dim(sb, s - i, 0, keepdims=False),
                (((0,), (0,)), ((), ())),
                preferred_element_type=jnp.int32,
            )

        d32 = jax.lax.fori_loop(
            0, s + 1, i_step,
            jnp.zeros((sa.shape[2], sb.shape[2]), jnp.int32),
        )
        return (acc + d32.astype(f64) * sc, sa, sb), None

    def group_prefix_sum(acc, sa, sb_rev_stack, rows):
        # Same-exponent groups as few long matmuls: group s's sum
        # ``sum_i sa_i^T @ sb_{s-i}`` equals ONE matmul between contiguous
        # prefix/suffix slices of the stacked slice arrays —
        # ``sa_all[: (s+1) rows].T @ sb_rev[(S-1-s) rows :]`` — because
        # row-block i of the prefix meets row-block (s-i) of the
        # reversed-and-right-aligned suffix. Contractions grow from ``rows``
        # to ``S*rows`` instead of 55 short-contraction products,
        # bit-identical (int32 sums are exact either way, valid for row
        # counts <= _GROUP_CHUNK). One f64 convert+scale+add per group — ~5x
        # less recombination work than per-pair accumulation.
        s_groups = sa.shape[0]
        sa_all = sa.reshape(s_groups * rows, sa.shape[2])
        # sb arrives stacked in REVERSED slice order (reversing the Python
        # list before jnp.stack is free; reversing a stacked array would
        # materialise a second multi-GB copy at genomics-wide K).
        sb_rev = sb_rev_stack.reshape(s_groups * rows, sb_rev_stack.shape[2])
        for s in range(s_groups):
            d32 = jax.lax.dot_general(
                jax.lax.slice_in_dim(sa_all, 0, (s + 1) * rows, axis=0),
                jax.lax.slice_in_dim(
                    sb_rev, (s_groups - 1 - s) * rows, s_groups * rows, axis=0
                ),
                (((0,), (0,)), ((), ())),
                preferred_element_type=jnp.int32,
            )
            acc = acc + d32.astype(f64) * (2.0 ** (-_T_BITS * (s + 2.0)))
        return acc

    acc = jnp.zeros((a.shape[1], b.shape[1]), dtype=f64)
    # Chunk over rows so every int32 accumulation is provably exact.
    for start in range(0, max(n, 1), _MAX_CHUNK):
        stop = min(start + _MAX_CHUNK, n)
        sa = jnp.stack(_mantissa_slices(a_scaled[start:stop], n_slices))
        sb_list = _mantissa_slices(b_scaled[start:stop], n_slices)
        small_out = a.shape[1] * b.shape[1] <= 2048 * 2048
        if stop - start <= _GROUP_CHUNK and small_out:
            acc = group_prefix_sum(acc, sa, jnp.stack(sb_list[::-1]),
                                   stop - start)
        elif stop - start <= _GROUP_CHUNK:
            group_scale = 2.0 ** (-_T_BITS * (np.arange(n_slices) + 2.0))
            (acc, _, _), _ = jax.lax.scan(
                group_step,
                (acc, sa, jnp.stack(sb_list)),
                (
                    jnp.arange(n_slices, dtype=jnp.int32),
                    jnp.asarray(group_scale, f64),
                ),
            )
        else:
            (acc, _, _), _ = jax.lax.scan(
                pair_step,
                (acc, sa, jnp.stack(sb_list)),
                (
                    jnp.asarray(pairs_i, jnp.int32),
                    jnp.asarray(pairs_j, jnp.int32),
                    jnp.asarray(pair_scale, f64),
                ),
            )
    out = acc * _pow2(e_a[:, None] + e_b[None, :])
    return out.astype(out_dtype)


def symmetric_contract(
    a: jax.Array,
    b: jax.Array,
    k: int,
    *,
    n_slices: int = _N_SLICES,
    col_block: int = 2048,
    out_dtype: Optional[jnp.dtype] = None,
    unweighted_x: bool = False,
) -> jax.Array:
    """``a.T @ b`` exploiting symmetry of the leading ``(k, k)`` block (SYRK).

    ``a`` is the weighted operand (N, k) and ``b = [X | Y]`` (N, k + m) with
    ``b[:, :k]`` the unweighted twin of ``a``, so ``(a.T @ b)[:, :k]`` is
    symmetric (the fit products, ref ``cvmatrix/cvmatrix.py:1215-1217``).
    Only the upper-triangular column-block pairs of the X block are
    computed — one :func:`ozaki_contract`-grade int8 contraction per
    pair, scanned so the trace stays one block pair deep — and the strict
    lower blocks are mirrored. At ``B`` column blocks this skips
    ``(B-1)/2B`` of the matmul work (~45% at B=10), which dominates at
    genomics-wide ``k``.

    ``unweighted_x``: assert that ``b[:, :k]`` is *the same values* as ``a``
    (the unweighted fit, where ``WX`` aliases ``X`` — ref
    ``cvmatrix/cvmatrix.py:1200-1203``). The column exponents, rescale and
    mantissa slicing of the X block are then computed ONCE and shared by
    both operands, halving the slicing subgraph (trace + the f64
    elementwise work, which at genomics-wide ``k`` is gigabytes per pass).

    Accuracy: identical arithmetic to :func:`ozaki_contract` per computed
    block. Mirrored entries equal their transposed twins *exactly*; they
    differ from a full computation only through the rounding asymmetry of
    the weighted operand (``fl(w*x)_i * x_j  vs  fl(w*x)_j * x_i``),
    ~2^-53 relative — far inside the engine's contract.
    """
    if out_dtype is None:
        out_dtype = a.dtype
    n, ka = a.shape
    m = b.shape[1] - k
    assert ka == k, (ka, k)
    f64 = jnp.float64

    # Equalize block widths over the block count instead of fixing cb at
    # col_block: with cb = col_block, k just above a block multiple (e.g.
    # k = 2049) padded the last block to a full col_block and the
    # upper-triangular pass did ~3x MORE matmul work than a plain full
    # contraction. With nb equal blocks of ~k/nb columns the mirrored
    # cost is (nb+1)/(2 nb) of the full product for every k — always a
    # saving at nb >= 2.
    nb = max(2, -(-k // col_block))
    cb = _round_up_pow2_cap(-(-k // nb))
    nb = -(-k // cb)
    ka_pad = nb * cb

    e_a = _column_scale(a)
    a_scaled = a.astype(f64) * _pow2(-e_a)[None, :]
    if ka_pad != k:
        a_scaled = jnp.pad(a_scaled, ((0, 0), (0, ka_pad - k)))
    if unweighted_x:
        e_bx = e_a
        bx_scaled = a_scaled
    else:
        e_bx = _column_scale(b[:, :k])
        bx_scaled = b[:, :k].astype(f64) * _pow2(-e_bx)[None, :]
        if ka_pad != k:
            bx_scaled = jnp.pad(bx_scaled, ((0, 0), (0, ka_pad - k)))
    if m:
        e_y = _column_scale(b[:, k:])
        y_scaled = b[:, k:].astype(f64) * _pow2(-e_y)[None, :]
    else:
        e_y = None
        y_scaled = None

    # Upper-triangular block pairs (bi <= bj), as column starts.
    pairs = np.array(
        [(i * cb, j * cb) for i in range(nb) for j in range(i, nb)],
        dtype=np.int32,
    )
    bi_arr = jnp.asarray(pairs[:, 0])
    bj_arr = jnp.asarray(pairs[:, 1])

    group_scale = [2.0 ** (-_T_BITS * (s + 2.0)) for s in range(n_slices)]

    def pair_tile(sa_flat, sb_flat, rows, bi, bj):
        """Raw f64 accumulator tile for column-block pair (bi, bj)."""
        sa_ij = jax.lax.dynamic_slice_in_dim(sa_flat, bi, cb, axis=1)
        sb_ij = jax.lax.dynamic_slice_in_dim(sb_flat, bj, cb, axis=1)
        # Dots first, recombination chained after (same left-fold order —
        # bit identical): each dot is a fusion barrier, so interleaving
        # the adds would round-trip the f64 tile through device memory per
        # group; chaining them afterwards fuses the recombination into one
        # output pass.
        d32s = [
            jax.lax.dot_general(
                jax.lax.slice_in_dim(sa_ij, 0, (s + 1) * rows, axis=0),
                jax.lax.slice_in_dim(
                    sb_ij, (n_slices - 1 - s) * rows,
                    n_slices * rows, axis=0,
                ),
                (((0,), (0,)), ((), ())),
                preferred_element_type=jnp.int32,
            )
            for s in range(n_slices)
        ]
        acc = d32s[0].astype(f64) * group_scale[0]
        for s in range(1, n_slices):
            acc = acc + d32s[s].astype(f64) * group_scale[s]
        return acc

    # Output assembly happens in-place inside a scan over pairs: each step
    # scales its tile by the position-dependent column exponents and writes
    # the tile AND its transposed twin straight into the padded (ka_pad,
    # ka_pad) carry via dynamic_update_slice (XLA keeps the carry buffer
    # in-place). Scaling BEFORE mirroring matters: entry (p, q) carries
    # 2^(e_a[p] + e_bx[q]), and e_a - e_bx is NOT column-constant for
    # weighted fits, so transposing raw accumulator blocks and scaling by
    # output position afterwards would be wrong by
    # 2^((e_a-e_bx)[p] - (e_a-e_bx)[q]) on every mirrored entry; the
    # power-of-two scaling is exact, so scaling first changes nothing else.
    # The transposed twin is written FIRST so diagonal pairs (bi == bj) end
    # with the untransposed tile. Versus the previous scatter assembly
    # (transposed twin stack + (nb, nb, cb, cb) grid + grid transpose —
    # ~3 output-sized temporaries, ~10 GB at genomics-wide k), the live set
    # here is one output buffer + one tile.
    e_a_pad = jnp.pad(e_a, (0, ka_pad - k))
    e_bx_pad = jnp.pad(e_bx, (0, ka_pad - k))

    def scale_write(buf, tile_raw, bi, bj):
        row_e = jax.lax.dynamic_slice_in_dim(e_a_pad, bi, cb)
        col_e = jax.lax.dynamic_slice_in_dim(e_bx_pad, bj, cb)
        tile = tile_raw * _pow2(row_e[:, None] + col_e[None, :])
        buf = jax.lax.dynamic_update_slice(buf, tile.T, (bj, bi))
        return jax.lax.dynamic_update_slice(buf, tile, (bi, bj))

    # Row chunks sized so prefix-stack int32 group sums stay exact:
    # n_slices * chunk * 65^2 < 2^31.
    chunk = _GROUP_CHUNK
    n_chunks = max(1, -(-max(n, 1) // chunk))
    # Multi-chunk fits accumulate raw tiles across chunks before the write
    # pass; single-chunk fits (the genomics-wide shape: small N, huge K)
    # fuse compute + write into one scan and skip the stack entirely.
    outs = None if n_chunks == 1 else jnp.zeros((len(pairs), cb, cb), f64)
    buf = jnp.zeros((ka_pad, ka_pad), f64)
    y_acc = jnp.zeros((ka_pad, m), f64) if m else None
    for start in range(0, max(n, 1), chunk):
        stop = min(start + chunk, n)
        rows = stop - start
        sl_a = _mantissa_slices(a_scaled[start:stop], n_slices)
        sa = jnp.stack(sl_a)
        # Unweighted: the X block's slices ARE a's slices — restack the same
        # list reversed (a second concat of existing buffers) instead of
        # re-slicing the whole block through 10 more f64 passes.
        sl_bx = (sl_a if unweighted_x
                 else _mantissa_slices(bx_scaled[start:stop], n_slices))
        sb_rev = jnp.stack(sl_bx[::-1])
        sa_flat = sa.reshape(n_slices * rows, ka_pad)
        sb_flat = sb_rev.reshape(n_slices * rows, ka_pad)

        if n_chunks == 1:
            def pair_write(carry, ij, sa_flat=sa_flat, sb_flat=sb_flat,
                           rows=rows):
                bi, bj = ij
                tile = pair_tile(sa_flat, sb_flat, rows, bi, bj)
                return scale_write(carry, tile, bi, bj), None

            buf, _ = jax.lax.scan(pair_write, buf, (bi_arr, bj_arr))
        else:
            def pair_body(carry, ij, sa_flat=sa_flat, sb_flat=sb_flat,
                          rows=rows):
                bi, bj = ij
                return carry, pair_tile(sa_flat, sb_flat, rows, bi, bj)

            _, outs_chunk = jax.lax.scan(pair_body, None, (bi_arr, bj_arr))
            outs = outs + outs_chunk

        if m:
            sy = jnp.stack(
                _mantissa_slices(y_scaled[start:stop], n_slices)[::-1]
            ).reshape(n_slices * rows, m)
            for s in range(n_slices):
                d32 = jax.lax.dot_general(
                    jax.lax.slice_in_dim(sa_flat, 0, (s + 1) * rows, axis=0),
                    jax.lax.slice_in_dim(
                        sy, (n_slices - 1 - s) * rows, n_slices * rows,
                        axis=0,
                    ),
                    (((0,), (0,)), ((), ())),
                    preferred_element_type=jnp.int32,
                )
                y_acc = y_acc + d32.astype(f64) * group_scale[s]

    if n_chunks > 1:
        def write_body(carry, t_ij):
            tile_raw, bi, bj = t_ij
            return scale_write(carry, tile_raw, bi, bj), None

        buf, _ = jax.lax.scan(write_body, buf, (outs, bi_arr, bj_arr))
    out_x = buf[:k, :k]

    if m:
        out_y = y_acc[:k] * _pow2(e_a[:, None] + e_y[None, :])
        return jnp.concatenate([out_x, out_y], axis=1).astype(out_dtype)
    return out_x.astype(out_dtype)


def _round_up_pow2_cap(k: int) -> int:
    """Largest sane block width for ``k`` columns (multiple of 128)."""
    return max(128, ((k + 127) // 128) * 128)


def outer_accumulate_contract(a: jax.Array, b: jax.Array) -> jax.Array:
    """``a.T @ b`` as a scan of rank-one outer-product updates.

    Avoids ``dot_general`` entirely: every multiply/add is an elementwise
    float64 operation. Used by the exact mode for small
    contraction lengths (per-fold validation blocks: N_val of a few rows, the
    LOOCV case being N_val = 1), where mantissa slicing would be overhead and
    a scan of length N_val is cheap. Exact same result order as a sequential
    accumulation (error ~ N_val * eps64).
    """
    n = a.shape[0]
    if n == 1:
        return a[0][:, None] * b[0][None, :]

    def step(carry, xy):
        x, y = xy
        return carry + x[:, None] * y[None, :], None

    init = jnp.zeros((a.shape[1], b.shape[1]), dtype=a.dtype)
    acc, _ = jax.lax.scan(step, init, (a, b))
    return acc


def _use_exact(mode: str) -> bool:
    if mode == "exact":
        return True
    if mode == "native":
        return False
    if mode != "auto":
        # CVConfig validates its own matmul_mode, but direct contract()
        # callers bypass that — a typo must not silently become "auto".
        raise ValueError(
            f"Unknown matmul mode: {mode!r} (auto|exact|native)."
        )
    return False  # auto: the native dot is float64 on CPU and GPU


# Minimum symmetric-block width for the SYRK route: below ~2048 there is a
# single column block and mirroring saves nothing (module constant so tests
# can lower it and drive the route at test scale).
_SYRK_MIN_K = 2048


def contract(
    a: jax.Array,
    b: jax.Array,
    *,
    mode: str = "auto",
    small_n_threshold: int = 16,
    symmetric_k: Optional[int] = None,
    unweighted_x: bool = False,
) -> jax.Array:
    """``a.T @ b`` contraction over axis 0, precision-policy aware.

    This is the single entry point used by both the fit-time global products
    (reference ``cvmatrix/cvmatrix.py:1209-1217``) and the per-fold
    validation-block downdate products (``:1001``).

    ``symmetric_k``: when the leading ``(k, k)`` output block is known
    symmetric (``b[:, :k]`` is the unweighted twin of ``a`` — the fit
    call), wide-``k`` exact contractions route through the SYRK path.
    ``unweighted_x``: additionally asserts ``b[:, :k]`` holds the same
    values as ``a`` (unweighted fit: WX aliases X, ref :1200-1203), letting
    the SYRK path slice the X mantissas once for both operands.
    """
    if _use_exact(mode):
        if a.shape[0] <= small_n_threshold:
            return outer_accumulate_contract(a, b)
        if symmetric_k is not None and symmetric_k >= _SYRK_MIN_K:
            # Wide k is matmul-bound; skipping the lower-triangular column
            # block pairs saves (B-1)/2B of the matmul work.
            return symmetric_contract(a, b, symmetric_k,
                                      unweighted_x=unweighted_x)
        return ozaki_contract(a, b)
    return jax.lax.dot_general(
        a,
        b,
        (((0,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    )
