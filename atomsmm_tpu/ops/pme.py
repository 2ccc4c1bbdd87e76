"""Smooth Particle-Mesh Ewald — reciprocal-space electrostatics.

Replaces openmm's PME (SURVEY.md §2b N1: charge spreading, 3-D FFT,
reciprocal convolution, self/exclusion corrections). Design:

  * B-spline charge spreading is recast as dense per-dimension one-hot
    weight matrices combined by chunked matmuls:
    Q[a, bc] += Wx_chunk^T @ (q * (Wy ⊗ Wz))_chunk — no scatter in the
    differentiated path, so forces via jax.grad are matmuls + FFTs. Every
    spreading product runs at Precision.HIGHEST (plain FP32): on a GPU the
    default f32 matmul runs in TF32, whose 10-bit input mantissa puts a
    ~1e-3 relative error on every reciprocal force;
  * reciprocal sum: one jnp.fft.fftn over the charge grid, analytic
    Gaussian/spline filter, O(K^3) elementwise;
  * direct space (erfc pairs) lives in the nonbonded pair path
    (forces.py::NonbondedForce method='pme'); this module adds the reciprocal
    term, the self energy, and the excluded-pair erf corrections.

Conventions: E_rec = k_e/(2 pi V) sum_{m != 0} exp(-pi^2 |m~|^2 / alpha^2)
/ |m~|^2 |b1 b2 b3|^2 |FFT(Q)(m)|^2, with m~ = (m1/L1, m2/L2, m3/L3)
(Essmann et al., J. Chem. Phys. 103, 8577 (1995)).
"""
from __future__ import annotations

import math
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..units import ONE_4PI_EPS0
from .pbc import minimum_image


@partial(jax.custom_jvp, nondiff_argnums=(1,))
def bspline_weights(t, order: int):
    """Cardinal B-spline values M_order(t + j) for j = 0..order-1, t in [0,1).

    Uses the stable recurrence M_n(u) = [u M_{n-1}(u) + (n-u) M_{n-1}(u-1)]
    / (n-1). Returns shape t.shape + (order,). Weights sum to 1.

    The derivative is supplied analytically (custom_jvp below): autodiff
    through the max/abs kinks of the M_2 seed picks wrong subgradients when
    t == 0 EXACTLY (an atom sitting precisely on a grid plane), producing
    weight derivatives that sum to -1 instead of 0 and O(100 kJ/mol/nm)
    force errors on that atom. Positions quantized by io round-trips or f32
    storage DO land exactly on grid planes in practice — a frozen-state
    hydrogen at x = 0.8 L broke every grid with 5 | K this way while
    leaving {2,3}-smooth grids untouched (tools/pme_order_study.py).
    """
    # The recurrence seed is M_2, so order < 2 would return M_2 values
    # mislabeled as a lower order (ADVICE r3). order == 2 values are exact
    # (the seed itself); differentiation additionally needs order >= 3 — see
    # the jvp below and the spline_order validation at PME construction.
    if order < 2:
        raise ValueError(f"B-spline order must be >= 2, got {order}")
    # M_2(u) on u = t + j: nonzero for u in (0, 2)
    u = t[..., None] + jnp.arange(order, dtype=t.dtype)
    m = jnp.maximum(1.0 - jnp.abs(u - 1.0), 0.0)  # M_2
    for n in range(3, order + 1):
        m_shift = jnp.concatenate(
            [jnp.zeros_like(m[..., :1]), m[..., :-1]], axis=-1
        )  # M_{n-1}(u - 1)
        m = (u * m + (n - u) * m_shift) / (n - 1)
    return m


@bspline_weights.defjvp
def _bspline_weights_jvp(order, primals, tangents):
    """Exact derivative via d/du M_n(u) = M_{n-1}(u) - M_{n-1}(u - 1):
    with u = t + j, dw_j/dt = M_{order-1}(t + j) - M_{order-1}(t + j - 1).
    Branch-free and correct at t = 0 exactly (where the recurrence's
    autodiff is not); rows sum to 0 as a telescoping sum."""
    (t,), (dt,) = primals, tangents
    if order < 3:
        # the order-1 inner call below would return M_2 values mislabeled as
        # M_1, silently producing wrong PME forces (ADVICE r3)
        raise ValueError(
            f"B-spline derivative requires order >= 3, got {order}")
    w = bspline_weights(t, order)
    wl = bspline_weights(t, order - 1)  # M_{order-1}(t + j), j = 0..order-2
    zero = jnp.zeros_like(wl[..., :1])
    upper = jnp.concatenate([wl, zero], axis=-1)  # M_{o-1}(t + j)
    lower = jnp.concatenate([zero, wl], axis=-1)  # M_{o-1}(t + j - 1)
    dw = upper - lower
    return w, dw * dt[..., None]


def _bspline_moduli(k: int, order: int, dtype):
    """|b(m)|^2 for one dimension (Euler exponential spline factors)."""
    # M_order(j + 1) for j = 0..order-2
    mvals = np.zeros(order - 1)
    # evaluate recursively in float64 on host
    def M(n, u):
        if n == 2:
            return max(1.0 - abs(u - 1.0), 0.0)
        return (u * M(n - 1, u) + (n - u) * M(n - 1, u - 1)) / (n - 1)

    for j in range(order - 1):
        mvals[j] = M(order, j + 1.0)
    m = np.arange(k)
    denom = np.zeros(k, dtype=np.complex128)
    for j in range(order - 1):
        denom += mvals[j] * np.exp(2j * np.pi * m * j / k)
    b2 = 1.0 / np.maximum(np.abs(denom) ** 2, 1e-14)
    # At the Nyquist mode m = K/2 the denominator is the alternating sum
    # sum_j M_order(j+1) (-1)^j, which cancels EXACTLY for odd orders (the
    # symmetric pairs (j, order-2-j) carry opposite signs) — order 5 on an
    # even grid returned inf before this was zeroed. Even orders are finite
    # there but the mode's Gaussian weight is ~e^-30; zeroing it
    # unconditionally on even grids is uniformly safe and parity-proof
    # (tools/pme_order_study.py).
    if k % 2 == 0:
        b2[k // 2] = 0.0
    return jnp.asarray(b2, dtype)


def spread_charges(x, box, q, grid_shape: Tuple[int, int, int],
                   order: int = 4, chunk: int = 2048):
    """Spread point charges onto the (K1, K2, K3) grid with B-splines.

    Chunked over atoms; per chunk, per-dimension dense weight matrices
    (C, K_d) are built by comparing grid iota against the spline support
    indices (mask-don't-branch), then combined with one matmul.
    """
    if order < 3:
        # PME forces differentiate the spreading weights; the analytic
        # derivative (bspline_weights jvp) requires order >= 3 (ADVICE r3)
        raise ValueError(
            f"PME spline_order must be >= 3, got {order}")
    k1, k2, k3 = grid_shape
    n = x.shape[0]
    dtype = x.dtype
    n_chunks = -(-n // chunk)
    n_pad = n_chunks * chunk - n
    xp = jnp.pad(x, ((0, n_pad), (0, 0)))
    qp = jnp.pad(q, (0, n_pad))  # padded charges are 0 -> no contribution

    kvec = jnp.asarray([k1, k2, k3], dtype)
    x_rows = xp.reshape(n_chunks, chunk, 3)
    q_rows = qp.reshape(n_chunks, chunk)

    iotas = [jnp.arange(k, dtype=jnp.int32) for k in (k1, k2, k3)]

    def dense_w(u_d, k_d, iota):
        """(C, K_d) spreading matrix for one dimension."""
        m0 = jnp.floor(u_d).astype(jnp.int32)
        t = u_d - jnp.floor(u_d)
        w = bspline_weights(t, order)  # (C, order), w[j] at grid (m0 - j)
        out = jnp.zeros((u_d.shape[0], k_d), dtype)
        for j in range(order):
            idx = jnp.mod(m0 - j, k_d)
            out = out + w[:, j : j + 1] * (iota[None, :] == idx[:, None])
        return out

    def body(Q, inp):
        xc, qc = inp
        if box.ndim == 1:
            u = xc / box * kvec  # fractional grid coordinates
        else:  # triclinic: fractional via inv(H) (rows = lattice vectors);
            # full precision — a TF32 matmul would quantize POSITIONS to a
            # 10-bit mantissa
            u = jnp.matmul(xc, jnp.linalg.inv(box),
                           precision=jax.lax.Precision.HIGHEST) * kvec
        wx = dense_w(u[:, 0], k1, iotas[0])
        wy = dense_w(u[:, 1], k2, iotas[1])
        wz = dense_w(u[:, 2], k3, iotas[2])
        wyz = (wy[:, :, None] * wz[:, None, :]).reshape(chunk, k2 * k3)
        # Precision.HIGHEST: preferred_element_type alone only sets the
        # ACCUMULATOR dtype; at default precision a GPU rounds the INPUTS
        # to TF32 (rel ~1e-3), a broad error on every reciprocal force.
        # HIGH is TF32 too on a GPU, so only HIGHEST keeps FP32 inputs
        # (chip_smoke.py gates the forces against the f64 reference).
        contrib = jnp.dot(
            wx.T, qc[:, None] * wyz, preferred_element_type=dtype,
            precision=jax.lax.Precision.HIGHEST,
        )  # (K1, K2*K3)
        return Q + contrib, None

    Q0 = jnp.zeros((k1, k2 * k3), dtype)
    Q, _ = jax.lax.scan(body, Q0, (x_rows, q_rows))
    return Q.reshape(k1, k2, k3)


def _frac_grid_coords(x, box, kvec):
    """Fractional grid coordinates u in [0, K) per dimension.

    HIGHEST precision on the triclinic transform — a TF32 matmul would
    quantize positions to a 10-bit mantissa.
    """
    if box.ndim == 1:
        return x / box * kvec
    return jnp.matmul(x, jnp.linalg.inv(box),
                      precision=jax.lax.Precision.HIGHEST) * kvec


def _local_window_weights(t, off, order: int, w_size: int, dtype):
    """(..., w_size) one-hot spreading rows within a block-local window.

    t: (...,) spline fraction in [0, 1); off: (...,) int32 local index of the
    FIRST support point (base) inside the window. Support point j
    (j = 0..order-1) of the dense formulation sits at grid (m0 - j), i.e.
    local index off + (order-1) - j.
    """
    w = bspline_weights(t, order)  # (..., order)
    iota = jnp.arange(w_size, dtype=jnp.int32)
    out = jnp.zeros(t.shape + (w_size,), dtype)
    for j in range(order):
        idx = off + (order - 1 - j)
        out = out + w[..., j : j + 1] * (iota == idx[..., None])
    return out


def _fold_axis(local, nb_axis: int, w_axis: int, b: int, s: int):
    """Fold a (nb, W = b + s) blocked axis pair into length b per block,
    adding each block's trailing s-point spill into the NEXT block's head
    (periodic: jnp.roll wraps the last block onto block 0)."""
    own = jax.lax.slice_in_dim(local, 0, b, axis=w_axis)
    spill = jax.lax.slice_in_dim(local, b, b + s, axis=w_axis)
    spill = jnp.roll(spill, 1, axis=nb_axis)
    idx = [slice(None)] * local.ndim
    idx[w_axis] = slice(0, s)
    return own.at[tuple(idx)].add(spill)


def _bucket_by_block(bid, n: int, nbtot: int, cap: int,
                     binning: str = "sort"):
    """Fixed-capacity (nbtot, cap) buckets of atom ids from per-atom block
    ids (sentinel n in empty slots; atoms ranked past cap are dropped —
    callers surface that via spread_block_overflow).

    Both methods produce IDENTICAL buckets (ascending atom id within each
    block), so downstream sums are bitwise-equal:

    * 'sort' (default): one packed value sort (the neighbors.py
      key-carries-payload idiom) + segment ranks.
    * 'hist': matmul histogram ranking — EXPERIMENTAL, not the default.
      Rank-within-block = (earlier same-block atoms in my 128-atom chunk,
      via a strictly-lower-triangular matmul against the chunk's block
      one-hot) + (same-block atoms in earlier chunks, via an exclusive
      chunk-histogram prefix); every product is 0/1 and every within-chunk
      count <= 127, so bf16 is exact on any backend. The (N, nbtot)
      one-hot construction is itself compare/select work that scales with
      nbtot, where the sort does not.
    """
    if binning == "sort":
        idx_bits = max(n - 1, 1).bit_length()
        if (nbtot << idx_bits) < 2**31:
            packed = jnp.sort(
                (bid << idx_bits) | jnp.arange(n, dtype=jnp.int32))
            perm = packed & ((1 << idx_bits) - 1)
            sorted_bid = packed >> idx_bits
        else:
            perm = jnp.argsort(bid).astype(jnp.int32)
            sorted_bid = bid[perm]
        iarr = jnp.arange(n, dtype=jnp.int32)
        first = jnp.concatenate(
            [jnp.ones((1,), bool), sorted_bid[1:] != sorted_bid[:-1]]
        )
        seg_start = jax.lax.cummax(jnp.where(first, iarr, 0))
        rank = iarr - seg_start
        ok = rank < cap
        slot = jnp.where(ok, sorted_bid * cap + rank, nbtot * cap)
        bucket = jnp.full((nbtot * cap,), n, jnp.int32)
        return bucket.at[slot].set(perm, mode="drop").reshape(nbtot, cap)
    if binning != "hist":
        raise ValueError(f"binning must be 'hist' or 'sort', got {binning!r}")
    c = 128
    nchunk = -(-n // c)
    npad = nchunk * c
    # padding rows get bid = nbtot: all-zero one-hot, masked at the scatter
    bidp = jnp.concatenate(
        [bid, jnp.full((npad - n,), nbtot, jnp.int32)]).reshape(nchunk, c)
    iota = jnp.arange(nbtot, dtype=jnp.int32)
    oh = (bidp[:, :, None] == iota).astype(jnp.bfloat16)  # (nchunk, c, nbtot)
    counts = jnp.sum(oh.astype(jnp.float32), axis=1)      # (nchunk, nbtot)
    pre = jnp.cumsum(counts, axis=0) - counts             # exclusive, f32
    tri = jnp.tril(jnp.ones((c, c), jnp.bfloat16), -1)
    within = jnp.einsum("ij,cjb->cib", tri, oh,
                        preferred_element_type=jnp.bfloat16)
    safe = jnp.minimum(bidp, nbtot - 1)[..., None]
    rw = jnp.take_along_axis(within, safe, axis=2)[..., 0]
    pc = jnp.take_along_axis(pre, jnp.minimum(bidp, nbtot - 1), axis=1)
    rank = pc.astype(jnp.int32) + rw.astype(jnp.int32)    # (nchunk, c)
    ids = jnp.arange(npad, dtype=jnp.int32).reshape(nchunk, c)
    ok = (ids < n) & (rank < cap)
    slot = jnp.where(ok, bidp * cap + rank, nbtot * cap).reshape(-1)
    bucket = jnp.full((nbtot * cap,), n, jnp.int32)
    return bucket.at[slot].set(ids.reshape(-1),
                               mode="drop").reshape(nbtot, cap)


def spread_charges_blocked(x, box, q, grid_shape: Tuple[int, int, int],
                           order: int, block: Tuple[int, int, int],
                           cap: int, binning: str = "sort"):
    """Block-binned B-spline charge spreading (same result as
    spread_charges, ~10-50x fewer MACs at production grids).

    The dense one-hot formulation costs N*K1*K2*K3 MACs because every atom's
    weight row spans the FULL grid dimension even though only `order` entries
    are nonzero. Here atoms are binned by the grid block containing their
    spline support base (`_bucket_by_block`), the
    one-hot matmuls run inside (B_d + order - 1) local windows, and the
    per-block local grids are folded into the global grid with three
    axis-roll adds — no scatter anywhere in the differentiated path, so
    jax.grad stays matmuls + FFTs. Cost: nblocks * cap * W1*W2*W3 MACs.

    Atoms beyond `cap` in a block are DROPPED from the sum — callers must
    surface spread_block_overflow (forces.pme_coverage_flags does; the flag
    is sticky and Context.step raises on it).
    """
    k1, k2, k3 = grid_shape
    b1, b2, b3 = block
    s = order - 1
    if k1 % b1 or k2 % b2 or k3 % b3:
        raise ValueError(f"block {block} must divide grid {grid_shape}")
    if min(b1, b2, b3) < s:
        # spill may only reach the immediately-next block
        raise ValueError(f"block {block} must be >= order-1 = {s}")
    nb1, nb2, nb3 = k1 // b1, k2 // b2, k3 // b3
    w1, w2, w3 = b1 + s, b2 + s, b3 + s
    nbtot = nb1 * nb2 * nb3
    n = x.shape[0]
    dtype = x.dtype

    kvec = jnp.asarray([k1, k2, k3], dtype)
    kint = jnp.asarray([k1, k2, k3], jnp.int32)
    bint = jnp.asarray([b1, b2, b3], jnp.int32)
    u = _frac_grid_coords(x, box, kvec)
    m0 = jnp.floor(u)
    t = u - m0  # (N, 3) spline fractions
    base = jnp.mod(m0.astype(jnp.int32) - s, kint)  # first support point
    blk = base // bint
    off = base - blk * bint  # in [0, B_d)
    bid = (blk[:, 0] * nb2 + blk[:, 1]) * nb3 + blk[:, 2]
    bucket = _bucket_by_block(bid, n, nbtot, cap, binning)

    # gather per-slot data; index n lands on the zero pad row
    qp = jnp.concatenate([q, jnp.zeros((1,), q.dtype)])
    tp = jnp.concatenate([t, jnp.zeros((1, 3), t.dtype)])
    op = jnp.concatenate([off, jnp.zeros((1, 3), off.dtype)])
    g_q = qp[bucket]          # (nbtot, cap)
    g_t = tp[bucket]          # (nbtot, cap, 3)
    g_o = op[bucket]          # (nbtot, cap, 3)

    wx = _local_window_weights(g_t[..., 0], g_o[..., 0], order, w1, dtype)
    wy = _local_window_weights(g_t[..., 1], g_o[..., 1], order, w2, dtype)
    wz = _local_window_weights(g_t[..., 2], g_o[..., 2], order, w3, dtype)
    wyz = (wy[..., :, None] * wz[..., None, :]).reshape(nbtot, cap, w2 * w3)
    # batched (W1, cap) @ (cap, W2*W3); Precision.HIGHEST — see
    # spread_charges
    local = jax.lax.dot_general(
        wx, g_q[..., None] * wyz,
        dimension_numbers=(((1,), (1,)), ((0,), (0,))),
        preferred_element_type=dtype,
        precision=jax.lax.Precision.HIGHEST,
    )  # (nbtot, W1, W2*W3)
    local = local.reshape(nb1, nb2, nb3, w1, w2, w3)
    local = _fold_axis(local, 0, 3, b1, s)
    local = _fold_axis(local, 1, 4, b2, s)
    local = _fold_axis(local, 2, 5, b3, s)
    # (nb1, nb2, nb3, B1, B2, B3) -> (K1, K2, K3)
    return local.transpose(0, 3, 1, 4, 2, 5).reshape(k1, k2, k3)


def spread_block_overflow(x, box, grid_shape, order: int, block, cap: int):
    """True when any spreading block holds more than `cap` atoms (those atoms
    would be silently dropped by spread_charges_blocked). One bincount —
    cheap enough to run every step from forces.pme_coverage_flags."""
    k1, k2, k3 = grid_shape
    b1, b2, b3 = block
    nb2, nb3 = k2 // b2, k3 // b3
    kint = jnp.asarray([k1, k2, k3], jnp.int32)
    bint = jnp.asarray([b1, b2, b3], jnp.int32)
    u = _frac_grid_coords(x, box, jnp.asarray([k1, k2, k3], x.dtype))
    base = jnp.mod(jnp.floor(u).astype(jnp.int32) - (order - 1), kint)
    blk = base // bint
    bid = (blk[:, 0] * nb2 + blk[:, 1]) * nb3 + blk[:, 2]
    nbtot = (k1 // b1) * nb2 * nb3
    counts = jnp.zeros((nbtot,), jnp.int32).at[bid].add(1)
    return jnp.max(counts) > cap


def _spread_frac_base(x, box, grid_shape, order: int):
    """(t, base): per-atom spline fractions in [0, 1) and the grid index of
    the FIRST support point (mod K) — shared by every spreading
    formulation."""
    k1, k2, k3 = grid_shape
    kint = jnp.asarray([k1, k2, k3], jnp.int32)
    u = _frac_grid_coords(x, box, jnp.asarray([k1, k2, k3], x.dtype))
    m0 = jnp.floor(u)
    t = u - m0
    base = jnp.mod(m0.astype(jnp.int32) - (order - 1), kint)
    return t, base


def build_spread_bucket(x, box, grid_shape, order: int, block, cap: int,
                        binning: str = "sort"):
    """(bucket, overflow): fixed-capacity (nbtot, cap) block buckets of atom
    ids at the CURRENT configuration, plus the build-time capacity-overflow
    flag (atoms ranked past cap are dropped from the bucket — never
    silently: the flag is sticky through forces.update_pme_spread and
    Context.step raises on it).

    The bucket stays EXACT for spread_charges_stale while every atom's
    support base remains within `pad` grid cells of its build-time block —
    the PME analog of a Verlet list's skin."""
    k1, k2, k3 = grid_shape
    b1, b2, b3 = block
    nb2, nb3 = k2 // b2, k3 // b3
    nbtot = (k1 // b1) * nb2 * nb3
    _, base = _spread_frac_base(x, box, grid_shape, order)
    blk = base // jnp.asarray(block, jnp.int32)
    bid = (blk[:, 0] * nb2 + blk[:, 1]) * nb3 + blk[:, 2]
    n = x.shape[0]
    bucket = _bucket_by_block(bid, n, nbtot, cap, binning)
    counts = jnp.zeros((nbtot,), jnp.int32).at[bid].add(1)
    return bucket, jnp.max(counts) > cap


def _fold_axis_padded(local, nb_axis: int, w_axis: int, b: int, s: int,
                      pad: int):
    """Fold a (nb, W = pad + b + s + pad) padded blocked axis pair into
    length b per block. The leading `pad` points belong to the PREVIOUS
    block's tail (roll -1); the trailing s + pad points spill into the
    following block(s) — two of them when s + pad > b (roll +1, +2, ...).
    Periodic throughout: jnp.roll wraps, which is also correct when the
    spill distance wraps clear around a small axis (block i+nb ≡ i)."""
    own = jax.lax.slice_in_dim(local, pad, pad + b, axis=w_axis)
    if pad:
        head = jnp.roll(
            jax.lax.slice_in_dim(local, 0, pad, axis=w_axis), -1,
            axis=nb_axis)
        idx = [slice(None)] * local.ndim
        idx[w_axis] = slice(b - pad, b)
        own = own.at[tuple(idx)].add(head)
    start, shift, remaining = pad + b, 1, s + pad
    while remaining > 0:
        chunk = min(remaining, b)
        spill = jnp.roll(
            jax.lax.slice_in_dim(local, start, start + chunk, axis=w_axis),
            shift, axis=nb_axis)
        idx = [slice(None)] * local.ndim
        idx[w_axis] = slice(0, chunk)
        own = own.at[tuple(idx)].add(spill)
        start, shift, remaining = start + chunk, shift + 1, remaining - chunk
    return own


def _wrap_grid_delta(delta, kint):
    """Minimum-image wrap of integer grid-index differences to
    [-K/2, K/2)."""
    m = jnp.mod(delta, kint)
    return jnp.where(m > kint // 2, m - kint, m)


def spread_charges_stale(x, box, q, grid_shape: Tuple[int, int, int],
                         order: int, block: Tuple[int, int, int],
                         cap: int, pad: int, bucket):
    """Block-binned spreading against a FROZEN bucket (build_spread_bucket,
    up to `pad` grid cells of drift ago) — the amortized variant of
    spread_charges_blocked (KERNELS.md "next lever": the bucket build is
    ~1.8 ms of grid-independent sort work per eval, while atoms move far
    less than a grid cell per step).

    Local windows are padded by `pad` cells on EACH side, so an atom whose
    support base drifted at most `pad` cells from its build-time block
    still lands EXACTLY (this is not an approximation — the result equals
    spread_charges while the drift bound holds). Atoms drifted beyond the
    pad contribute ZERO; callers must surface that through
    forces.pme_spread_stale_flags (sticky; Context.step raises) and
    rebuild the bucket via forces.update_pme_spread well before the bound
    (trigger: drift > pad/2, the Verlet skin/2 idiom)."""
    k1, k2, k3 = grid_shape
    b1, b2, b3 = block
    s = order - 1
    if k1 % b1 or k2 % b2 or k3 % b3:
        raise ValueError(f"block {block} must divide grid {grid_shape}")
    if pad < 1:
        raise ValueError("spread_charges_stale requires pad >= 1; use "
                         "spread_charges_blocked for per-step buckets")
    if min(b1, b2, b3) < pad:
        # the head spill reaches only the immediately-previous block
        raise ValueError(f"block {block} must be >= pad = {pad}")
    nb1, nb2, nb3 = k1 // b1, k2 // b2, k3 // b3
    w1, w2, w3 = b1 + s + 2 * pad, b2 + s + 2 * pad, b3 + s + 2 * pad
    nbtot = nb1 * nb2 * nb3
    n = x.shape[0]
    dtype = x.dtype

    kint = jnp.asarray([k1, k2, k3], jnp.int32)
    t, base = _spread_frac_base(x, box, grid_shape, order)

    # static per-row block origins in grid coordinates
    r = jnp.arange(nbtot, dtype=jnp.int32)
    blk = jnp.stack(
        [r // (nb2 * nb3), (r // nb3) % nb2, r % nb3], axis=-1)
    origin = blk * jnp.asarray(block, jnp.int32)  # (nbtot, 3)

    # gather per-slot data; index n lands on the zero pad row
    qp = jnp.concatenate([q, jnp.zeros((1,), q.dtype)])
    tp = jnp.concatenate([t, jnp.zeros((1, 3), t.dtype)])
    bp = jnp.concatenate([base, jnp.zeros((1, 3), base.dtype)])
    g_q = qp[bucket]              # (nbtot, cap)
    g_t = tp[bucket]              # (nbtot, cap, 3)
    g_b = bp[bucket]              # (nbtot, cap, 3)

    delta = _wrap_grid_delta(g_b - origin[:, None, :], kint)
    off = delta + pad             # local index of the support base
    bvec = jnp.asarray(block, jnp.int32)
    valid = jnp.all((off >= 0) & (off <= bvec + 2 * pad - 1), axis=-1)
    g_q = g_q * valid             # drifted-out atoms are dropped, flagged

    wx = _local_window_weights(g_t[..., 0], off[..., 0], order, w1, dtype)
    wy = _local_window_weights(g_t[..., 1], off[..., 1], order, w2, dtype)
    wz = _local_window_weights(g_t[..., 2], off[..., 2], order, w3, dtype)
    wyz = (wy[..., :, None] * wz[..., None, :]).reshape(nbtot, -1, w2 * w3)
    local = jax.lax.dot_general(
        wx, g_q[..., None] * wyz,
        dimension_numbers=(((1,), (1,)), ((0,), (0,))),
        preferred_element_type=dtype,
        precision=jax.lax.Precision.HIGHEST,
    )  # (nbtot, W1, W2*W3)
    local = local.reshape(nb1, nb2, nb3, w1, w2, w3)
    local = _fold_axis_padded(local, 0, 3, b1, s, pad)
    local = _fold_axis_padded(local, 1, 4, b2, s, pad)
    local = _fold_axis_padded(local, 2, 5, b3, s, pad)
    return local.transpose(0, 3, 1, 4, 2, 5).reshape(k1, k2, k3)


def spread_stale_exceeded(x, box, grid_shape, order: int, block, pad: int,
                          x_ref, box_ref):
    """EXACT per-step validity check for spread_charges_stale: True when
    some atom's support base drifted beyond the representable window of the
    block it was bucketed under at the reference configuration. O(N)
    compares — cheap enough to sample after every step (the PME analog of
    ops.neighbors.staleness_flags)."""
    kint = jnp.asarray(grid_shape, jnp.int32)
    bvec = jnp.asarray(block, jnp.int32)
    _, base_now = _spread_frac_base(x, box, grid_shape, order)
    _, base_ref = _spread_frac_base(
        x_ref, jnp.asarray(box_ref, x_ref.dtype), grid_shape, order)
    # the kernel's EXACT predicate in the kernel's EXACT frame: the bucket
    # binned each atom under origin = (base_ref // B) * B at build time, and
    # spread_charges_stale keeps an atom iff every axis of
    # d = wrap(base_now - origin) lies in [-pad, B + pad - 1] (its `valid`
    # mask: off = d + pad in [0, B + 2*pad - 1]). Using the same bound and
    # the same wrap means NO drift can be dropped-but-unflagged (the old
    # bound B + 2*pad - 1 left a pad-wide silent gap — ADVICE r4 high).
    # Note no box != box_ref term: binning is by FRACTIONAL grid position,
    # which an affine box rescale (MC barostat move) preserves, so a box
    # change invalidates nothing that the base comparison does not already
    # catch — and the blanket term falsely tripped the sticky flag on every
    # accepted volume move (ADVICE r4 medium).
    origin = (base_ref // bvec) * bvec
    d = _wrap_grid_delta(base_now - origin, kint)
    bad = (d < -pad) | (d > bvec + pad - 1)
    return jnp.any(bad)


def spread_bucket_rebuild_trigger(x, box, grid_shape, pad: int,
                                  x_ref, box_ref):
    """Conservative rebuild predicate for the amortized bucket: some atom's
    fractional grid coordinate drifted beyond pad/2 cells (minimum-image),
    or the box changed — the skin/2 idiom of ops.neighbors.needs_rebuild,
    leaving half the pad as margin for motion between the check and the
    force evaluations it guards."""
    kvec = jnp.asarray(grid_shape, x.dtype)
    du = (_frac_grid_coords(x, box, kvec)
          - _frac_grid_coords(x_ref, jnp.asarray(box_ref, x_ref.dtype),
                              kvec))
    du = du - kvec * jnp.round(du / kvec)
    moved = jnp.max(jnp.abs(du)) > 0.5 * pad
    return moved | jnp.any(jnp.asarray(box) != jnp.asarray(box_ref))


def choose_spread_blocks(grid_shape, order: int, n: int,
                         x=None, box=None, safety: float = 1.3,
                         pad: int = 0):
    """Static (block, cap) for spread_charges_blocked (pad=0) or
    spread_charges_stale (pad>=1), or (None, 0) when blocking cannot beat
    the dense one-hot path.

    Host-side setup heuristic: enumerate divisor triples of the grid,
    estimate MACs = nblocks * cap * prod(B_d + order - 1 + 2*pad) with
    cap = safety * max-block-occupancy (measured from `x` when given, else
    2x the mean), and keep the cheapest triple that undercuts dense
    (n * K1*K2*K3) by at least 2x. Occupancy is re-measurable later via
    retune (forces.retune_pme_spread).

    Declines outright when dense spreading is already cheap
    (< 1 G MAC): the bucket build is grid-independent sort work, and below
    that scale it can eat the whole win (the 30k water grid, 45^3, is
    2.7 G MAC; emim 5.2k on 32^3 is 0.17 G). The threshold is a
    hypothesis to re-measure on the card."""
    k1, k2, k3 = grid_shape
    s = order - 1
    lo = max(4, s, pad)
    if float(n) * k1 * k2 * k3 < 1e9:
        return None, 0

    def divisors(k):
        return [d for d in range(lo, k + 1) if k % d == 0]

    dense_macs = float(n) * k1 * k2 * k3
    w_extra = s + 2 * pad
    best = None
    for d1 in divisors(k1):
        for d2 in divisors(k2):
            for d3 in divisors(k3):
                nbtot = (k1 // d1) * (k2 // d2) * (k3 // d3)
                if nbtot == 1:
                    continue
                if x is not None:
                    occ = _max_block_occupancy(
                        x, box, grid_shape, order, (d1, d2, d3))
                    cap = int(math.ceil(safety * max(occ, 1)))
                else:
                    cap = int(math.ceil(2.0 * n / nbtot))
                cap = max(cap, 8)
                macs = (nbtot * cap
                        * (d1 + w_extra) * (d2 + w_extra) * (d3 + w_extra))
                if best is None or macs < best[0]:
                    best = (macs, (d1, d2, d3), cap)
    if best is None or best[0] * 2.0 > dense_macs:
        return None, 0
    return best[1], best[2]


def _max_block_occupancy(x, box, grid_shape, order: int, block) -> int:
    """Measured max atoms per spreading block (host-side numpy)."""
    x = np.asarray(x, np.float64)
    box = np.asarray(box, np.float64)
    k = np.asarray(grid_shape)
    if box.ndim == 1:
        u = x / box * k
    else:
        u = x @ np.linalg.inv(box) * k
    base = np.mod(np.floor(u).astype(np.int64) - (order - 1), k)
    blk = base // np.asarray(block)
    nb = k // np.asarray(block)
    bid = (blk[:, 0] * nb[1] + blk[:, 1]) * nb[2] + blk[:, 2]
    return int(np.bincount(bid, minlength=int(nb.prod())).max())


def pme_reciprocal_energy(x, box, q, alpha, grid_shape, order: int = 4,
                          chunk: int = 2048, spread_block=None,
                          spread_cap: int = 0, spread_pad: int = 0,
                          spread_bucket=None):
    """Reciprocal-space PME energy [kJ/mol]. With spread_block/spread_cap
    set (see choose_spread_blocks), spreading runs block-binned; with
    spread_pad >= 1 AND a frozen spread_bucket it additionally amortizes
    the bucket across steps (spread_charges_stale — exact while the drift
    bound holds; Context maintains the bucket + guards)."""
    if spread_block and spread_pad and spread_bucket is not None:
        Q = spread_charges_stale(
            x, box, q, grid_shape, order, spread_block, spread_cap,
            spread_pad, spread_bucket)
    elif spread_block:
        Q = spread_charges_blocked(
            x, box, q, grid_shape, order, spread_block, spread_cap)
    else:
        Q = spread_charges(x, box, q, grid_shape, order, chunk)
    return pme_reciprocal_from_grid(Q, box, alpha, grid_shape, order)


def pme_influence(box, alpha, grid_shape, order: int, dtype,
                  k2_indices=None):
    """The reciprocal influence weight W(m) such that
    E = sum_m W(m) |Q^hat(m)|^2 on the half-spectrum (k3r = K3//2 + 1)
    layout — includes the Gaussian filter, B-spline moduli, the rfft
    double-count column weights AND the 1/(2 pi V) prefactor.

    k2_indices: optional (B,) int32 row subset along K2 — the sharded slab
    FFT (parallel/spatial.py) holds only a K2/D block of the spectrum per
    device and needs exactly its block of the influence.
    """
    k1, k2, k3 = grid_shape
    k3r = k3 // 2 + 1

    def freqs(k):
        m = jnp.arange(k)
        return jnp.where(m <= k // 2, m, m - k).astype(dtype)

    f2_full = freqs(k2)
    b2_k2 = _bspline_moduli(k2, order, dtype)
    if k2_indices is not None:
        f2_full = f2_full[k2_indices]
        b2_k2 = b2_k2[k2_indices]

    if box.ndim == 1:
        m1 = freqs(k1)[:, None, None] / box[0]
        m2 = f2_full[None, :, None] / box[1]
        m3 = jnp.arange(k3r).astype(dtype)[None, None, :] / box[2]
        m2_tilde = m1 * m1 + m2 * m2 + m3 * m3
    else:
        # triclinic: |m|^2 = k^T G k with the reciprocal metric
        # G = inv(H)^T inv(H): x = s @ H so k.s = x . (inv(H) @ k), i.e.
        # m = inv(H) @ k and G[d,e] = sum_a invH[a,d] invH[a,e]
        inv_h = jnp.linalg.inv(box).astype(dtype)
        g = jnp.matmul(inv_h.T, inv_h,
                       precision=jax.lax.Precision.HIGHEST)
        f1 = freqs(k1)[:, None, None]
        f2 = f2_full[None, :, None]
        f3 = jnp.arange(k3r).astype(dtype)[None, None, :]
        m2_tilde = (
            g[0, 0] * f1 * f1 + g[1, 1] * f2 * f2 + g[2, 2] * f3 * f3
            + 2.0 * (g[0, 1] * f1 * f2 + g[0, 2] * f1 * f3
                     + g[1, 2] * f2 * f3)
        )

    b2 = (
        _bspline_moduli(k1, order, dtype)[:, None, None]
        * b2_k2[None, :, None]
        * _bspline_moduli(k3, order, dtype)[None, None, :k3r]
    )
    # the charge grid is real, so the last axis is the half-spectrum rfft:
    # interior k3 columns carry weight 2 (their conjugate twins are not
    # stored); k3 = 0 and the Nyquist column (even K3) appear once
    w3 = jnp.ones((k3r,), dtype)
    w3 = w3.at[1:].set(2.0)
    if k3 % 2 == 0:
        w3 = w3.at[-1].set(1.0)
    b2 = b2 * w3[None, None, :]
    from .pbc import box_volume

    volume = box_volume(box)
    pi2 = jnp.asarray(math.pi**2, dtype)
    safe_m2 = jnp.where(m2_tilde > 0, m2_tilde, 1.0)
    filt = jnp.where(
        m2_tilde > 0, jnp.exp(-pi2 * safe_m2 / alpha**2) / safe_m2, 0.0
    )
    return ONE_4PI_EPS0 / (2.0 * math.pi * volume) * filt * b2


def pme_reciprocal_from_grid(Q, box, alpha, grid_shape, order: int = 4):
    """FFT + reciprocal convolution of an already-spread charge grid —
    split out so the sharded path (parallel/spatial.py) can psum per-device
    grids before this replicated part."""
    Qhat = jnp.fft.rfftn(Q)
    w = pme_influence(box, alpha, grid_shape, order, Q.dtype)
    return jnp.sum(w * jnp.abs(Qhat) ** 2)


def pme_self_energy(q, alpha):
    return -ONE_4PI_EPS0 * alpha / math.sqrt(math.pi) * jnp.sum(q * q)


def pme_exclusion_correction(x, box, q, exclusions, alpha):
    """Remove reciprocal-space interactions of excluded pairs:
    -k_e q_i q_j erf(alpha r)/r summed over each excluded pair once.

    Flattened to (N*M,) 1-D ops rather than the natural (N, M[, 3])
    broadcast layout, whose minor dimension is tiny."""
    n, m = exclusions.shape
    ii = jnp.repeat(jnp.arange(n, dtype=exclusions.dtype), m)
    ej = exclusions.reshape(-1)
    valid = ej > ii  # each pair once (j > i); -1 padding drops here too
    j = jnp.clip(ej, 0, n - 1)
    dx = minimum_image(jnp.repeat(x, m, axis=0) - x[j], box)
    r2 = jnp.sum(dx * dx, axis=-1)
    r = jnp.sqrt(jnp.where(valid, r2, 1.0))
    qq = jnp.repeat(q, m) * q[j]
    e = -ONE_4PI_EPS0 * qq * jax.scipy.special.erf(alpha * r) / r
    return jnp.sum(jnp.where(valid, e, 0.0))


def pme_corrections(x, box, q, exclusions, alpha):
    """Self energy + excluded-pair corrections (everything but the pair loop
    and the FFT term)."""
    return pme_self_energy(q, alpha) + pme_exclusion_correction(
        x, box, q, exclusions, alpha
    )


# --------------------------------------------------------------------------
# Parameter selection (openmm-compatible heuristics)
# --------------------------------------------------------------------------


def _good_fft_size(n: int, multiple_of: int = 1) -> int:
    """Smallest size >= n with only factors 2, 3, 5 (and divisible by
    `multiple_of` — the sharded slab FFT needs K1 and K2 to split evenly
    across devices)."""
    while True:
        m = n
        for p in (2, 3, 5):
            while m % p == 0:
                m //= p
        if m == 1 and n % multiple_of == 0:
            return n
        n += 1


def choose_pme_parameters(r_cut, box, tol: float = 5e-4, alpha=None,
                          grid=None, order: int = 6, multiple_of: int = 1):
    """(alpha, (K1, K2, K3), order) from cutoff + error tolerance.

    alpha matches openmm.NonbondedForce's heuristic
    (sqrt(-log(2 tol))/r_cut). The grid uses the order-4 openmm rule
    K_d = ceil(2 alpha L_d / (3 tol^(1/5))) scaled by a per-order factor:
    in the one-hot matmul spreading formulation the per-atom cost is
    INDEPENDENT of the spline order (the dense (C, K_d) weight matrices
    have the same shape whatever the support width), so a higher order on
    a coarser grid is pure savings — wyz memory traffic scales with K² and
    the FFT with K³. Measured on the 30k water state vs an f64
    order-8/96³ oracle (tools/pme_order_study.py): order 6 at 0.75×K is
    strictly MORE accurate than order 4 at K (force RMS 8.1e-4 vs 2.9e-3,
    energy 4.7e-4 vs 1.2e-3) at ~2× less reciprocal work. Pass order=4
    for openmm-identical parameters."""
    box = np.asarray(box, np.float64)
    # triclinic (3, 3): size each grid dimension by its lattice-vector length
    lengths = box if box.ndim == 1 else np.linalg.norm(box, axis=1)
    if alpha is None:
        alpha = math.sqrt(-math.log(2.0 * tol)) / float(r_cut)
    if grid is None:
        # measured accuracy-preserving spacing factors relative to the
        # order-4 rule (pme_order_study.py; conservative interpolation)
        factor = _ORDER_SPACING_FACTOR.get(order, 1.0 if order < 4 else 0.65)
        grid = [
            _good_fft_size(
                int(math.ceil(factor * 2.0 * alpha * L / (3.0 * tol ** 0.2))),
                multiple_of,
            )
            for L in lengths
        ]
    return float(alpha), tuple(int(g) for g in grid), int(order)


_ORDER_SPACING_FACTOR = {4: 1.0, 5: 0.85, 6: 0.75, 7: 0.70, 8: 0.65}


def pme_validity_lengths(alpha, grid_shape, order, r_cut):
    """Per-dimension box-length bounds up to which a STATIC (alpha, grid)
    still meets its design error tolerance.

    alpha depends only on (r_cut, tol), so it stays valid under volume
    moves; the grid rule K >= factor * 2 alpha L / (3 tol^0.2) inverts to
    L_max = K * 3 tol^0.2 / (2 alpha factor). tol is recovered from the
    openmm alpha heuristic (alpha = sqrt(-log(2 tol))/r_cut) — exact when
    parameters came from choose_pme_parameters, the conservative
    default-tol assumption otherwise. NPT guard: see
    forces.pme_coverage_flags (VERDICT r3 #7).
    """
    alpha = float(alpha)
    tol = 0.5 * math.exp(-((alpha * float(r_cut)) ** 2))
    factor = _ORDER_SPACING_FACTOR.get(int(order),
                                       1.0 if order < 4 else 0.65)
    return tuple(
        k * 3.0 * tol ** 0.2 / (2.0 * alpha * factor) for k in grid_shape
    )


def ewald_reference_energy(x, box, q, alpha, kmax: int = 12):
    """Slow direct Ewald reciprocal sum (plane waves, no mesh) — test oracle
    for the PME implementation (SURVEY.md §7: goldens from analytic limits)."""
    n = x.shape[0]
    ms = []
    for mx in range(-kmax, kmax + 1):
        for my in range(-kmax, kmax + 1):
            for mz in range(-kmax, kmax + 1):
                if (mx, my, mz) != (0, 0, 0):
                    ms.append((mx, my, mz))
    ms = jnp.asarray(np.array(ms, np.float64), x.dtype)  # (M, 3) integer k
    if box.ndim == 1:
        m_tilde = ms / box[None, :]
    else:
        # m = inv(H) @ k per wavevector (x = s @ H convention)
        m_tilde = jnp.matmul(ms, jnp.linalg.inv(box).T,
                             precision=jax.lax.Precision.HIGHEST)
    m2 = jnp.sum(m_tilde * m_tilde, axis=1)
    phase = 2.0 * math.pi * jnp.matmul(
        x, m_tilde.T, precision=jax.lax.Precision.HIGHEST)  # (N, M)
    s_re = jnp.sum(q[:, None] * jnp.cos(phase), axis=0)
    s_im = jnp.sum(q[:, None] * jnp.sin(phase), axis=0)
    s2 = s_re**2 + s_im**2
    filt = jnp.exp(-math.pi**2 * m2 / alpha**2) / m2
    from .pbc import box_volume

    volume = box_volume(box)
    return ONE_4PI_EPS0 / (2.0 * math.pi * volume) * jnp.sum(filt * s2)
