"""Device kernels for the MSA/DP fallback path.

Batched device equivalents of the two hot loops of the reference's MSA fallback
(`correctByMSAlignment`):

* ``lf_extract``  — batched LF-walk string extraction across SA rows,
  the device form of retrieveStr's per-row per-base loop
  (PacBio/LongReadOverlap.cpp:700-751).  All rows advance in lockstep; a
  row that reaches '$' parks (sticky), so one jitted scan serves every
  (gap, SA-row) lane at once.
* ``banded_fill`` — the banded global/overlap DP cell fill of
  Overlapper::extendMatch (Thirdparty/overlapper.cpp:421-620), batched
  over (gap, candidate-read) lanes with per-lane band origins.  The fill
  is integer-exact: the host backtrack (core/overlapper.py) runs on the
  downloaded cells and produces byte-identical cigars/consensus.

The column recurrence's "up-chain" (curr[k] = max(base[k], curr[k-1]+gap))
is a running max of (base[k] - k*gap), computed with an associative scan —
the classic prefix-combine trick that keeps the whole column step
data-parallel instead of a sequential loop.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..index.fmindex import FMIndex

I32 = jnp.int32
INVALID = -(1 << 30)


@functools.partial(jax.jit, static_argnames=("max_steps",))
def _lf_extract_jit(blocks, ckpt, C, block, roots, max_steps):
    N = roots.shape[0]

    def occ_sym(sym, idx):
        p = (idx + 1).astype(I32)
        q = p // block
        r = p - q * block
        rows = blocks[q]
        lane = jax.lax.broadcasted_iota(I32, rows.shape, rows.ndim - 1)
        hits = (rows == sym[..., None].astype(jnp.int8)) & (lane < r[..., None])
        return ckpt[q, sym.astype(I32)] + hits.sum(axis=-1, dtype=I32)

    def step(carry, _):
        idx, alive = carry
        q = idx // block
        r = idx - q * block
        b = blocks[q, r].astype(I32)
        alive = alive & (b != 0)
        out = jnp.where(alive, b, 0).astype(jnp.int8)
        nxt = C[b] + occ_sym(b, idx - 1)
        idx = jnp.where(alive, nxt, idx)
        return (idx, alive), out

    (_, _), cols = jax.lax.scan(
        step, (roots.astype(I32), jnp.ones(N, bool)), None, length=max_steps)
    mat = jnp.swapaxes(cols, 0, 1)                      # [N, max_steps]
    lens = jnp.sum(mat != 0, axis=1, dtype=I32)
    return mat, lens


def lf_extract(fm: FMIndex, roots: np.ndarray, max_steps: int):
    """Device-batched ``core.msa._lf_extract``: next <= max_steps symbols
    reached by LF from each BWT row (per-row stop at '$').
    Returns (mat int8 [N, max_steps], lens [N]) as numpy.

    Shapes are bucketed (N to powers of two, steps to multiples of 256) so
    repeated calls with nearby sizes reuse one compiled kernel instead of
    paying a compile per distinct gap geometry."""
    if len(roots) == 0 or max_steps <= 0:
        return (np.zeros((len(roots), max(max_steps, 1)), np.int8),
                np.zeros(len(roots), np.int64))
    n = len(roots)
    n_pad = 1 << max(3, (n - 1).bit_length())
    steps_pad = 256 * ((max_steps + 255) // 256)
    r = np.zeros(n_pad, np.int64)
    r[:n] = np.asarray(roots, np.int64)
    mat, lens = _lf_extract_jit(
        fm.blocks, fm.ckpt, fm.C, fm.block, jnp.asarray(r, I32), steps_pad)
    return (np.asarray(mat)[:n, :max_steps],
            np.minimum(np.asarray(lens[:n], np.int64), max_steps))


@functools.partial(jax.jit, static_argnames=("bw", "num_cols", "scores"))
def _banded_fill_jit(q_mat, t_mat, t_len, band_origin, bw, num_cols, scores):
    """Cell fill for N lanes; cells[n, i, r] = DP(i, j = origin_n + i + r).

    Matches core/overlapper.extend_match's loop (zero boundary init, diag
    from slot r, left from slot r+1 of the previous column, no left on the
    last band row, up-chain within the column)."""
    match, gap, mismatch = scores
    N = q_mat.shape[0]
    num_rows = t_len + 1                                # [N]
    ks = jnp.arange(bw, dtype=I32)

    def col(cells_prev, i):
        # i: 1-based column index (scan over 1..num_cols)
        j0 = band_origin + i                            # [N]
        rows = j0[:, None] + ks[None, :]                # [N, bw] candidate j
        in_band = (rows >= jnp.maximum(j0, 1)[:, None]) & (
            rows < jnp.minimum(j0 + bw, num_rows)[:, None])
        qch = q_mat[jnp.arange(N), jnp.minimum(i - 1, q_mat.shape[1] - 1)]
        tch = t_mat[jnp.arange(N)[:, None],
                    jnp.clip(rows - 1, 0, t_mat.shape[1] - 1)]
        sub = jnp.where(tch == qch[:, None], match, mismatch)
        diag = cells_prev + sub
        left = jnp.where(ks[None, :] + 1 < bw,
                         jnp.roll(cells_prev, -1, axis=1) + gap, INVALID)
        # the last in-band row of the column has no left predecessor
        n_in = jnp.sum(in_band, axis=1)                 # [N]
        first = jnp.argmax(in_band, axis=1).astype(I32)
        last = first + n_in - 1
        is_last = (ks[None, :] == last[:, None]) & (n_in[:, None] > 1)
        base = jnp.where(is_last, diag, jnp.maximum(diag, left))
        # up-chain via running max of (base - k*gap)
        shifted = base - ks[None, :] * gap
        # chain must not cross out-of-band gaps: reset at not-in-band slots
        shifted = jnp.where(in_band, shifted, INVALID)
        run = jax.lax.associative_scan(jnp.maximum, shifted, axis=1)
        curr = run + ks[None, :] * gap
        curr = jnp.where(in_band, curr, 0)
        return curr, curr

    init = jnp.zeros((N, bw), I32)
    _, cols = jax.lax.scan(col, init,
                           jnp.arange(1, num_cols + 1, dtype=I32))
    cells = jnp.swapaxes(cols, 0, 1)                    # [N, num_cols, bw]
    return jnp.concatenate([init[:, None, :], cells], axis=1)


def banded_fill(queries: list[str], targets: list[str], starts1, starts2,
                band_width: int, scores=(1, -1, -8)) -> np.ndarray:
    """Batched extend_match cell fill.

    queries/targets: N sequences (padded internally); starts1/starts2: the
    per-lane anchor positions; scores = (match, gap, mismatch) — the MSA
    call sites use match 1 / gap -1 / mismatch -8
    (PacBio/LongReadOverlap.cpp:633-638).
    Returns int64 cells [N, max_cols + 1, bw] aligned with
    core.overlapper.extend_match's band layout."""
    from ..core import alphabet as ab

    N = len(queries)
    half = band_width // 2
    bw = half * 2 + 1
    # bucket shapes (N -> pow2, lengths -> multiples of 128) so gap-varying
    # geometries share compiled kernels
    n_pad = 1 << max(2, (N - 1).bit_length()) if N else 4
    max_q = max((len(q) for q in queries), default=1)
    max_t = max((len(t) for t in targets), default=1)
    max_q = 128 * ((max_q + 127) // 128)
    max_t = 128 * ((max_t + 127) // 128)
    q_mat = np.zeros((n_pad, max_q), np.int8)
    t_mat = np.full((n_pad, max_t), -1, np.int8)
    t_len = np.zeros(n_pad, np.int32)
    origin = np.zeros(n_pad, np.int32)
    for n, (q, t) in enumerate(zip(queries, targets)):
        q_mat[n, : len(q)] = ab.encode(q)
        t_mat[n, : len(t)] = ab.encode(t)
        t_len[n] = len(t)
        origin[n] = starts2[n] - starts1[n] + 1 - (half + 1)
    cells = _banded_fill_jit(
        jnp.asarray(q_mat), jnp.asarray(t_mat), jnp.asarray(t_len),
        jnp.asarray(origin), bw, int(max_q), tuple(int(s) for s in scores))
    return np.asarray(cells, np.int64)[:N]
