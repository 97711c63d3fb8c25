"""Device-side seed probing: the searchSeedsWithHybridKmers state machine.

Moves the WHOLE seed phase onto the device — per-position k-mer tables
(ops.scan), position attributes, the sequential dynamic-k-mer scan
(LongReadProbe.cpp:34-117), low-complexity rejection, best-k estimation
(SeedFeature.cpp:43-78) and hitchhike removal (LongReadProbe.cpp:187-227)
— so only the per-seed records are read back, not the [k, reads, L]
freq/valid tables.

Exactness: the host scan compares in float32 throughout, which the device
reproduces bit-for-bit.  The one float64 in the attribute window
(ratio + 0.0005 >= 0.02, LongReadProbe.cpp:176) folds into a precomputed
f32 constant: q + a >= b on an f32 q is exact in f64 and equivalent to
q >= ceil_f32(b - a).

The automaton runs one inner-loop iteration per lax.while step for all
reads in parallel; finished lanes idle.  Seeds whose best-k walk leaves
the table's k range are flagged for host re-estimation (rare: extreme
repeats only).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

I32 = jnp.int32
F32 = jnp.float32

SMAX = 128  # seed slots per read


def _attr_ratio_const() -> np.float32:
    """ceil_f32(f64(0.02) - f64(0.0005)) — see module docstring."""
    b = np.float64(0.02) - np.float64(0.0005)
    c = np.float32(b)
    if np.float64(c) < b:
        c = np.nextafter(c, np.float32(np.inf))
    return c


_RATIO_C = float(_attr_ratio_const())


def _col(arr, idx):
    """arr[r, idx[r]] for [R, L] arr, [R] idx (clipped)."""
    return jnp.take_along_axis(
        arr, jnp.clip(idx, 0, arr.shape[1] - 1)[:, None], axis=1)[:, 0]


@partial(jax.jit, static_argnames=("scan_k",))
def _attributes(freq_scan, prefix, lens, rep_thr, scan_k: int):
    """getSeqAttribute (LongReadProbe.cpp:120-182), [R, L] lanes.

    freq_scan [R, L] i32 (scan-k freq, -1 fake), prefix [R, L+1, 4] i32,
    lens [R], rep_thr f32 scalar (thresh.get(2, scan_k))."""
    R, L = freq_scan.shape
    pos = jnp.arange(L, dtype=I32)
    sizes = jnp.minimum(scan_k, lens[:, None] - pos)        # [R, L]
    take = jnp.clip(jnp.minimum(pos + scan_k, lens[:, None]), 0, L)
    base = jnp.broadcast_to(pos[None, :, None], (R, L, 1))
    counts = (
        jnp.take_along_axis(prefix, take[..., None], axis=1)
        - jnp.take_along_axis(prefix, base, axis=1)
    )                                                       # [R, L, 4]
    srt = jnp.sort(counts, axis=-1)
    fs = sizes.astype(F32)
    lowcx = (srt[..., 3].astype(F32) / fs >= jnp.float32(0.7)) | (
        (srt[..., 2] + srt[..., 3]).astype(F32) / fs >= jnp.float32(0.9))
    eff = jnp.where(lowcx, -1, freq_scan)
    add_garbage = eff < 0
    rem_garbage = eff <= 0
    repeat = ~add_garbage & (eff.astype(F32) >= rep_thr)
    rep_rem = ~rem_garbage & (eff.astype(F32) >= rep_thr)

    cs_add_g = jnp.cumsum(add_garbage.astype(I32), axis=1)
    cs_rem_g = jnp.cumsum(rem_garbage.astype(I32), axis=1)
    cs_add_r = jnp.cumsum(repeat.astype(I32), axis=1)
    cs_rem_r = jnp.cumsum(rep_rem.astype(I32), axis=1)

    def csum_at(cs, idx):
        v = jnp.take_along_axis(cs, jnp.clip(idx, 0, L - 1), axis=1)
        return jnp.where(idx < 0, 0, v)

    half = 150
    left = jnp.broadcast_to(jnp.maximum(pos - half, 0)[None, :], (R, L))
    right = jnp.minimum(pos + half, lens[:, None] - 1)
    box_garbage = csum_at(cs_add_g, right) - csum_at(cs_rem_g, left - 1)
    box_repeat = csum_at(cs_add_r, right) - csum_at(cs_rem_r, left - 1)
    size = (right - left + 1) - box_garbage
    q = box_repeat.astype(F32) / size.astype(F32)
    return jnp.where(q >= jnp.float32(_RATIO_C), 2, 1).astype(I32)


@partial(jax.jit, static_argnames=("start_kmer", "up_bound", "offsets",
                                   "hh_ratio"))
def _scan_automaton(freq, valid, attr, prefix, lens, thr_table,
                    start_kmer: int, up_bound: int, offsets: tuple,
                    hh_ratio: float):
    """search_seeds' nested whiles as one lax.while over [R] lanes
    (LongReadProbe.cpp:46-104 / core/seeds.py:search_seeds).

    freq [K, R, L] i32, valid [K, R, L] bool, attr [R, L] i32,
    prefix [R, L+1, 4] i32, lens [R], thr_table [3, K] f32.
    Emits SoA seed records (start, size, max_fixed, repeat, static) + n.
    """
    K, R, L = freq.shape
    hh = jnp.float32(np.float32(hh_ratio))
    inv_hh = jnp.float32(np.float32(1.0) / np.float32(hh_ratio))
    off_arr = jnp.asarray(offsets, I32)
    rlane = jnp.arange(R)

    def fget(k, pos):
        kc = jnp.clip(k, 0, K - 1)
        pc = jnp.clip(pos, 0, L - 1)
        return freq[kc, rlane, pc], valid[kc, rlane, pc]

    def thrget(mode, size):
        return thr_table[jnp.clip(mode, 0, 2), jnp.clip(size, 0, K - 1)]

    ZI = jnp.zeros(R, I32)
    ZB = jnp.zeros(R, bool)
    state = dict(
        init_pos=ZI, stat=ZI, dyn_mode=ZI, seed_pos=ZI, dyn_size=ZI,
        is_seed=ZB, is_repeat=ZB, max_fixed=ZI, next_init=ZI, curr=ZI,
        inner=ZB, done=lens < start_kmer,
        n=ZI, starts=jnp.zeros((R, SMAX), I32), sizes=jnp.zeros((R, SMAX), I32),
        freqs=jnp.zeros((R, SMAX), I32), reps=jnp.zeros((R, SMAX), bool),
        statics=jnp.zeros((R, SMAX), I32),
    )

    def cond(s):
        return jnp.any(~s["done"])

    def body(s):
        live = ~s["done"]
        # ---- outer init for lanes entering a new window --------------------
        start_outer = live & ~s["inner"]
        ip = s["init_pos"]
        dmode = _col(attr, ip)
        stat0 = start_kmer + off_arr[jnp.clip(dmode, 0, 2)]
        fits0 = ip + stat0 <= lens
        mf0, _ = fget(stat0, ip)

        def sel(new, old):
            return jnp.where(start_outer, new, old)

        stat = sel(stat0, s["stat"])
        dyn_mode = sel(dmode, s["dyn_mode"])
        seed_pos = sel(ip, s["seed_pos"])
        dyn_size = sel(stat0, s["dyn_size"])
        is_seed = sel(ZB, s["is_seed"])
        is_rep = sel(ZB, s["is_repeat"])
        max_fixed = sel(jnp.where(fits0, mf0, -1), s["max_fixed"])
        next_init = sel(ip, s["next_init"])
        curr = sel(ip, s["curr"])

        # ---- one inner-loop iteration ---------------------------------------
        inner = live
        in_range = curr < lens
        static_fake = curr + stat > lens
        exit_now = inner & (~in_range | static_fake)

        work = inner & ~exit_now
        static_mode = _col(attr, curr)
        dyn_size = jnp.where(work & is_seed, dyn_size + 1, dyn_size)
        dyn_fake = seed_pos + dyn_size > lens
        dfreq, dvalid = fget(dyn_size, seed_pos)
        dyn_freq = jnp.where(dyn_fake, -1, dfreq)
        dyn_valid = jnp.where(dyn_fake, False, dvalid)
        sfreq, _ = fget(stat, curr)
        dyn_thr = thrget(dyn_mode, dyn_size)
        stat_thr = thrget(static_mode, stat)
        rep_thr = (jnp.float32(5)
                   - ((static_mode >> 1) << 2).astype(F32)) * stat_thr

        fail = (
            (sfreq.astype(F32) < stat_thr)
            | (dyn_freq.astype(F32) < dyn_thr)
            | ~dyn_valid
            | (dyn_size > up_bound)
        )
        fd = sfreq.astype(F32) / max_fixed.astype(F32)
        low = ~fail & (fd < hh)
        high = ~fail & ~low & (fd > inv_hh)
        go = work & ~fail & ~low & ~high
        exit_fail = work & fail
        exit_low = work & low
        exit_high = work & high

        dyn_size = jnp.where(exit_fail & is_seed, dyn_size - 1, dyn_size)
        dyn_size = jnp.where(exit_low, dyn_size - 1, dyn_size)
        next_init = jnp.where(exit_low, next_init + 1, next_init)
        next_init = jnp.where(exit_high, curr - 1, next_init)
        next_init = jnp.where(go, seed_pos + dyn_size - 1, next_init)
        is_seed = jnp.where(exit_high, False, is_seed)
        is_seed = jnp.where(go, True, is_seed)
        is_rep = is_rep | (go & (sfreq.astype(F32) >= rep_thr))
        max_fixed = jnp.where(go, jnp.maximum(max_fixed, sfreq), max_fixed)
        curr = jnp.where(go, curr + 1, curr)

        exiting = exit_now | exit_fail | exit_low | exit_high

        # ---- on exit: low-complexity check + emission -----------------------
        wc = (jnp.take_along_axis(
                  prefix, jnp.clip(seed_pos + dyn_size, 0, L)[:, None, None]
                  * jnp.ones((R, 1, 1), I32), axis=1)
              - jnp.take_along_axis(
                  prefix, jnp.clip(seed_pos, 0, L)[:, None, None]
                  * jnp.ones((R, 1, 1), I32), axis=1))[:, 0]  # [R, 4]
        cs = jnp.sort(wc, axis=-1)
        fsz = dyn_size.astype(F32)
        lowcx = (cs[:, 3].astype(F32) / fsz >= jnp.float32(0.7)) | (
            (cs[:, 2] + cs[:, 3]).astype(F32) / fsz >= jnp.float32(0.9))
        emit = exiting & is_seed & ~lowcx

        slot = jnp.clip(s["n"], 0, SMAX - 1)
        wcol = jax.lax.broadcasted_iota(I32, (R, SMAX), 1) == slot[:, None]
        wsel = wcol & emit[:, None]
        starts = jnp.where(wsel, seed_pos[:, None], s["starts"])
        sizes = jnp.where(wsel, dyn_size[:, None], s["sizes"])
        freqs = jnp.where(wsel, max_fixed[:, None], s["freqs"])
        reps = jnp.where(wsel, is_rep[:, None], s["reps"])
        statics = jnp.where(wsel, stat[:, None], s["statics"])
        n = jnp.where(emit & (s["n"] < SMAX), s["n"] + 1, s["n"])

        init_pos = jnp.where(exiting, next_init + 1, s["init_pos"])
        done = s["done"] | (exiting & (init_pos >= lens))

        return dict(
            init_pos=init_pos, stat=stat, dyn_mode=dyn_mode,
            seed_pos=seed_pos, dyn_size=dyn_size, is_seed=is_seed,
            is_repeat=is_rep, max_fixed=max_fixed, next_init=next_init,
            curr=curr, inner=live & ~exiting, done=done,
            n=n, starts=starts, sizes=sizes, freqs=freqs, reps=reps,
            statics=statics,
        )

    out = jax.lax.while_loop(cond, body, state)
    return (out["n"], out["starts"], out["sizes"], out["freqs"],
            out["reps"], out["statics"])


@partial(jax.jit, static_argnames=())
def _estimate_best(freq, n, starts, sizes, statics, pb_coverage):
    """estimateBestKmerSize for every seed lane (SeedFeature.cpp:43-78).

    [R, SMAX] seed lanes walk the boundary-kmer frequency ladder on the
    device freq table; lanes whose k leaves the table range are flagged
    for host re-estimation.
    Returns (start_k, end_k, out_of_range)."""
    K, R, L = freq.shape
    upper = pb_coverage >> 1
    lower = pb_coverage >> 2
    rl = jnp.arange(R)[:, None]
    valid_seed = jax.lax.broadcasted_iota(I32, starts.shape, 1) < n[:, None]

    def bfreq(k, pole_start):
        kc = jnp.clip(k, 1, K - 1)
        pos = jnp.where(pole_start, starts, starts + sizes - k)
        pc = jnp.clip(pos, 0, L - 1)
        return freq[kc, rl, pc], (k >= K) | (k < 1)

    def walk(pole_start):
        k = statics
        kf, oor0 = bfreq(k, pole_start)
        up = kf > upper
        down = kf < lower
        bit = jnp.where(up, 1, jnp.where(down, -1, 0))
        active = valid_seed & (bit != 0)
        freq_bound = jnp.where(bit > 0, upper, lower)
        cors_bound = jnp.where(bit > 0, lower, upper)
        size_bound = jnp.where(bit > 0, sizes, statics)
        oor = oor0 & active

        def cond(c):
            k, kf, act, oor = c
            return jnp.any(act)

        def body(c):
            k, kf, act, oor = c
            go = act & ((bit ^ kf) > (bit ^ freq_bound)) & (
                (bit ^ k) < (bit ^ size_bound))
            k2 = jnp.where(go, k + bit, k)
            kf2, o2 = bfreq(k2, pole_start)
            kf2 = jnp.where(go, kf2, kf)
            oor2 = oor | (go & o2)
            return k2, kf2, act & go, oor2

        k, kf, _, oor = jax.lax.while_loop(
            cond, body, (k, kf, active, oor))
        back = valid_seed & (bit != 0) & ((bit ^ kf) < (bit ^ cors_bound))
        k = jnp.where(back, k - bit, k)
        return k, oor

    sk, oor1 = walk(True)
    ek, oor2 = walk(False)
    return sk, ek, oor1 | oor2


@partial(jax.jit, static_argnames=("radius", "hh_ratio"))
def _remove_hitchhiking(n, starts, sizes, freqs, reps, radius: int,
                        hh_ratio: float):
    """removeHitchhikingSeeds (LongReadProbe.cpp:187-227), vectorised.

    The host loops qi<si with an early break when the gap exceeds the
    radius; starts ascend, so the break equals the window mask."""
    ends = starts + sizes - 1
    valid = jax.lax.broadcasted_iota(I32, starts.shape, 1) < n[:, None]
    q_end = ends[:, :, None]
    s_start = starts[:, None, :]
    iq = jax.lax.broadcasted_iota(I32, (1, SMAX, SMAX), 1)
    is_ = jax.lax.broadcasted_iota(I32, (1, SMAX, SMAX), 2)
    pair = (is_ > iq) & valid[:, :, None] & valid[:, None, :] & (
        s_start - q_end <= radius)
    fd = freqs[:, None, :].astype(F32) / freqs[:, :, None].astype(F32)
    hh = jnp.float32(np.float32(hh_ratio))
    inv_hh = jnp.float32(1.0) / hh
    # query q repeat & fd<hh -> SUBJECT s hitchhiked; subject s repeat &
    # fd>1/hh -> QUERY q hitchhiked (axes: 1 = q, 2 = s)
    subj_hit = pair & reps[:, :, None] & (fd < hh)
    query_hit = pair & reps[:, None, :] & (fd > inv_hh)
    hitch = jnp.any(subj_hit, axis=1) | jnp.any(query_hit, axis=2)
    return valid & ~hitch
