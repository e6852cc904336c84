"""Speculative chunk-lane entropy decode on the device.

The restart-lane kernel (:mod:`jpeg_tpu.entropy.device_decode2`) gets its
parallelism from restart segments — a 4K stream has ~135, far below where
the lockstep cost model saturates. This module manufactures lanes the way
the host speculative decoder does (``jt_decode_scan_planes_spec``,
``runtime/native/jpegtpu.cpp`` — after "Accelerating JPEG Decompression
on GPUs", arXiv 2111.09219): each restart segment (the whole scan, when
there are none) is split into byte-aligned CHUNKS, every chunk decodes
speculatively from its guessed start, and Huffman self-synchronization
makes most guesses converge to the true symbol stream within a few MCUs.

Pipeline:

1. **Device phase A** — one lockstep kernel pass over all (segment,
   chunk) lanes: each lane decodes whole MCUs (so sync candidates are
   MCU starts — no table-phase guessing needed), records its MCU-start
   bit positions, per-MCU DC prefix vectors, and fully-decoded count,
   and keeps decoding ``overlap_mcus`` past its chunk boundary.
2. **Host merge** — per segment, chain sync points from the
   ground-truth chunk 0: the first common recorded position between a
   lane's overlap and its successor's record IS a true MCU boundary
   (same position + same MCU phase by construction). Produces per-range
   source rows and per-component DC corrections. A broken link (the
   successor synced later than the predecessor's recorded overlap, or a
   lane never synced at all) triggers **gap recovery**: the host decodes
   sequentially from the verified end cursor until its bit position hits
   a recorded MCU start of any later lane — a handful of MCUs, patched
   into the output. Only genuine stream corruption fails the merge
   (caller falls back to the host tier, which reproduces the reference's
   error semantics). The merge inputs are the small control arrays
   (positions/counts/DC cumsums, ~1% of the coefficient volume);
   coefficients stay on device.
3. **Device relocate** — one row gather reorders verified MCUs into
   stream order and an elementwise add applies the DC corrections.

Output contract identical to the restart-lane decoders: [total_blocks,
64] i32, zigzag order, DC-predicted, MCU stream order. Reference
behavior contract: ``src/jpeg/huffman.rs:109-268``.

Verdict so far: chunk lanes raise S, but the lockstep cost is per
sequential STEP, not per lane, so on the hardware it was first measured on
the crossover with the host C++ tier never happened (see
``device_decode.device_path_profitable``). Not yet measured on the GPU.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from jpeg_tpu.entropy import oracle
from jpeg_tpu.entropy.device_decode import packed_luts
from jpeg_tpu.entropy.device_decode2 import (
    _make_block_decoder,
    _make_block_decoder_pair_lean,
    _make_register_ops,
    _make_register_ops64,
    _plan_pair_ids,
    _plan_slot_ids,
    _scan_words,
    _scan_words2,
)
from jpeg_tpu.io.container import DecodePlan

# MCUs a lane keeps decoding past its chunk boundary, hunting for the
# successor's sync point. The host tier uses 96; device lanes pay for the
# worst lane in lockstep, so the budget is tighter and a miss just means
# host fallback for that stream.
OVERLAP_MCUS = 24


@lru_cache(maxsize=64)
def _compiled_spec_kernel(n_comp: int, cap: int,
                          slot_comp: tuple, slot_dc: tuple, slot_ac: tuple,
                          overlap: int, pair: bool = False):
    """Speculative phase-A kernel for one (geometry, table-binding) class:
    every lane decodes up to ``cap`` whole MCUs from its own guessed
    bit-start, stopping at segment end / chunk end + overlap / bad parse.
    """
    bpm = len(slot_comp)

    def kernel(words, luts, bit_start, chunk_end_bit, seg_end_bit):
        """bit_start/chunk_end_bit/seg_end_bit: [S] i32 absolute bit
        positions (lane start guess, its chunk's end, its segment's end).
        Returns (out [S, cap*bpm, 64] i32 raw lane-local DC prediction;
        mcu_bits [S, cap+1] i32; dc_cum [S, cap+1, n_comp] i32;
        n_dec [S] i32). A lane whose speculative parse hits an invalid
        prefix simply dies — host gap recovery bridges its chunk (the
        in-kernel next-byte retry of the r3 first cut was removed: its
        iteration slack made cap ~2.3x the fair share, and with
        thousands of lanes the lockstep cost IS the iteration count)."""
        S = bit_start.shape[0]
        u32 = jnp.uint32
        if pair:
            n_words = words.shape[1]
            refill, consume = _make_register_ops64(words)
            decode_block = _make_block_decoder_pair_lean(
                refill, consume, S)
        else:
            n_words = words.shape[0]
            refill, consume = _make_register_ops(words)
            decode_block = _make_block_decoder(refill, consume, S)

        def reg_init(start_bit):
            wi0 = start_bit >> 5
            off0 = (start_bit & 31).astype(u32)
            w0 = (words[0] if pair
                  else words)[jnp.clip(wi0, 0, n_words - 1)]
            return (wi0 + 1, 32 - (start_bit & 31), w0 << off0,
                    jnp.zeros((S,), u32), jnp.zeros((S,), u32))

        def mcu_body(m, carry):
            (reg, alive, past_end, n_dec, prev_dc, out, mcu_bits,
             dc_cum) = carry
            pos = reg[0] * 32 - reg[1]
            mcu_bits = jax.lax.dynamic_update_slice(
                mcu_bits, pos[:, None], (0, m))
            past_end = past_end + (
                alive & (pos >= chunk_end_bit)).astype(jnp.int32)
            start_ok = (alive & (pos < seg_end_bit)
                        & (past_end <= overlap))
            err = jnp.zeros((S,), bool)
            base = m * bpm
            for slot in range(bpm):
                comp = slot_comp[slot]
                block, reg, err = decode_block(
                    reg, err, start_ok & ~err, luts[slot_dc[slot]],
                    luts[slot_ac[slot] if pair else 4 + slot_ac[slot]])
                dc = jnp.where(start_ok & ~err,
                               block[:, 0] + prev_dc[comp], prev_dc[comp])
                prev_dc = tuple(
                    dc if c == comp else prev_dc[c] for c in range(n_comp))
                block = block.at[:, 0].set(dc)
                block = jnp.where((start_ok & ~err)[:, None], block, 0)
                out = jax.lax.dynamic_update_slice(
                    out, block[:, None, :], (0, base + slot, 0))
            alive = start_ok & ~err
            n_dec = n_dec + alive.astype(jnp.int32)
            dc_cum = jax.lax.dynamic_update_slice(
                dc_cum, jnp.stack(prev_dc, axis=-1)[:, None, :],
                (0, m + 1, 0))
            return (reg, alive, past_end, n_dec, prev_dc, out, mcu_bits,
                    dc_cum)

        def cond(carry):
            m = carry[0]
            return (m < cap) & jnp.any(carry[1][1])

        def body(carry):
            m, st = carry
            return (m + 1, mcu_body(m, st))

        st = (reg_init(bit_start),
              jnp.ones((S,), bool),
              jnp.zeros((S,), jnp.int32),
              jnp.zeros((S,), jnp.int32),
              tuple(jnp.zeros((S,), jnp.int32) for _ in range(n_comp)),
              jnp.zeros((S, cap * bpm, 64), jnp.int32),
              jnp.zeros((S, cap + 1), jnp.int32),
              jnp.zeros((S, cap + 1, n_comp), jnp.int32))
        _m, st = jax.lax.while_loop(cond, body, (jnp.int32(0), st))
        reg, alive, _past, n_dec, _pdc, out, mcu_bits, dc_cum = st
        # Lanes still alive at exit ran out of iteration budget: record
        # their final cursor as the handoff entry. Stopped lanes already
        # recorded theirs pre-decode (a bad lane's cursor is mid-MCU —
        # its recorded entry is the correct one).
        pos = reg[0] * 32 - reg[1]
        cols = jax.lax.broadcasted_iota(jnp.int32, mcu_bits.shape, 1)
        mcu_bits = jnp.where(
            (cols == n_dec[:, None]) & alive[:, None],
            pos[:, None], mcu_bits)
        return out, mcu_bits, dc_cum, n_dec

    return jax.jit(kernel)


def _chunk_lanes(plan: DecodePlan, target_lanes: int):
    """Split every restart segment into byte-aligned chunks totalling
    ~target_lanes lanes. Returns per-lane numpy arrays + per-segment
    grouping info."""
    segs = plan.segments
    total_bytes = sum(s.byte_end - s.byte_start for s in segs)
    lane_start, lane_chunk_end, lane_seg_end = [], [], []
    groups = []  # (segment, first_lane, n_chunks)
    for s in segs:
        nbytes = s.byte_end - s.byte_start
        k = max(1, min(
            round(target_lanes * nbytes / max(total_bytes, 1)),
            nbytes // 64 or 1))
        first = len(lane_start)
        for j in range(k):
            b0 = s.byte_start + nbytes * j // k
            b1 = s.byte_start + nbytes * (j + 1) // k
            lane_start.append(b0 * 8)
            lane_chunk_end.append(b1 * 8)
            lane_seg_end.append(s.byte_end * 8)
        groups.append((s, first, k))
    return (np.array(lane_start, np.int32),
            np.array(lane_chunk_end, np.int32),
            np.array(lane_seg_end, np.int32), groups)


def _host_gap_decode(plan, start_bit, prev_dc, later, n_mcus_left,
                     seg_end_byte):
    """Sequentially decode MCUs from absolute bit position ``start_bit``
    (a verified MCU boundary within ``plan.scan_data``) until the cursor
    lands on a recorded MCU start of one of ``later`` — a list of
    ``(ci, {bit_position: lane_local_index})`` for lanes after the broken
    one — or ``n_mcus_left`` MCUs are decoded. Returns
    (blocks [g, bpm, 64] i32 absolute-DC, dc_after, resume (ci, idx) |
    None, g) or None on an invalid prefix (genuine stream corruption).

    Fast path: the C++ runtime's ``jt_decode_gap`` (sub-us per MCU vs
    ~0.2 ms for the Python oracle — gap recovery is on the merge's
    critical path). The oracle loop remains as the no-native fallback.

    ``later`` is (stop_pos sorted i64, stop_lane i32, stop_idx i32):
    the recorded MCU-start positions of all lanes AFTER the broken one,
    with their owning chunk index and lane-local record index."""
    slots = plan.component_block_slots()
    stop_pos, stop_lane, stop_idx = later
    try:
        from jpeg_tpu.runtime import native_decode_gap

        res = native_decode_gap(plan, int(start_bit), int(seg_end_byte),
                                stop_pos, int(n_mcus_left))
        if res is None:
            return None
        blocks, pos = res
        g = len(blocks)
        dc = prev_dc.copy()
        if g:
            # DC prediction per component over the slot-major stream.
            flat = blocks.reshape(g * len(slots), 64)
            for c in range(len(plan.components)):
                mask = np.fromiter(
                    (ci == c for ci, _ in slots), bool).astype(np.int64)
                deltas = flat[:, 0].astype(np.int64) * np.tile(mask, g)
                run = np.cumsum(deltas) + dc[c]
                sel = np.tile(mask, g).astype(bool)
                flat[sel, 0] = run[sel].astype(np.int32)
                if sel.any():
                    dc[c] = run[np.where(sel)[0][-1]]
        final_pos = int(pos[g - 1]) if g else int(start_bit)
        resume = None
        if g < n_mcus_left:
            resume = _resume_at(later, final_pos)
            if resume is None:
                return None  # stopped without a stop hit: corruption
        return blocks, dc, resume, g
    except ImportError:
        pass
    reader = oracle.BitReader(plan.scan_data[start_bit // 8:])
    reader.consume(start_bit & 7)
    byte0 = (start_bit // 8) * 8
    dc = prev_dc.copy()
    blocks = []
    while True:
        pos = byte0 + reader.bit_position
        resume = _resume_at(later, pos)
        if resume is not None:
            return (np.array(blocks, np.int32).reshape(
                len(blocks), len(slots), 64), dc, resume, len(blocks))
        if len(blocks) >= n_mcus_left:
            return (np.array(blocks, np.int32).reshape(
                len(blocks), len(slots), 64), dc, None, len(blocks))
        mcu = np.zeros((len(slots), 64), np.int32)
        try:
            for si, (ci, _sub) in enumerate(slots):
                comp = plan.components[ci]
                block = oracle.next_block(
                    reader, plan.ac_tables[comp.ac_id],
                    plan.dc_tables[comp.dc_id])
                block[0] += dc[ci]
                dc[ci] = block[0]
                mcu[si] = block
        except ValueError:
            return None
        blocks.append(mcu)


def _resume_at(later, pos):
    """(chunk index, lane-local record index) of the earliest later lane
    that recorded bit position ``pos``, or None."""
    stop_pos, stop_lane, stop_idx = later
    lo = np.searchsorted(stop_pos, pos)
    hi = np.searchsorted(stop_pos, pos, side="right")
    if lo == hi:
        return None
    j = lo + int(np.argmin(stop_lane[lo:hi]))
    return int(stop_lane[j]), int(stop_idx[j])


def _merge_segment(plan, seg, first, k, mcu_bits, dc_cum, n_dec, m0, cap,
                   n_comp):
    """Chain sync points for one segment's chunk lanes. Returns
    (src_rows [n_mcus_seg] global rows into the flattened [S*cap] lane-MCU
    axis, corr [n_mcus_seg, n_comp] DC corrections, patch_mcus,
    patch_blocks, gap_mcus) or None when gap recovery itself hits an
    invalid prefix (genuine corruption — caller falls back to the host
    tier). Lane-local MCU j lives at column m0[lane]+j (in-kernel retries
    shift a lane's accepted parse right). A broken sync link — the
    successor never recorded any of this lane's verified MCU starts — is
    bridged by :func:`_host_gap_decode`: the host decodes from the
    verified end cursor until it hits a recorded MCU start of ANY later
    lane (same self-sync argument as lane chaining: a shared bit position
    at MCU phase makes the two parses identical from there on), and those
    few MCUs are patched into the device output."""
    n_mcus = seg.mcu_count
    bpm = plan.blocks_per_mcu
    src = np.zeros(n_mcus, np.int64)
    corr = np.zeros((n_mcus, n_comp), np.int32)
    patch_mcus, patch_blocks = [], []
    gap_mcus = 0
    base = np.zeros(n_comp, np.int64)

    # One sorted (position, chunk, record-index) table for the whole
    # segment, built lazily at the first broken link; gap events slice
    # it by chunk index instead of rebuilding per-event dicts (the
    # per-event rebuild measured ~300 ms on a 1024-chunk no-restart 4K).
    stop_table = None

    def later_stops(ci):
        nonlocal stop_table
        if stop_table is None:
            parts_p, parts_l, parts_i = [], [], []
            for c in range(k):
                lane = first + c
                o, nd = int(m0[lane]), int(n_dec[lane])
                p = mcu_bits[lane, o: o + nd + 1].astype(np.int64)
                parts_p.append(p)
                parts_l.append(np.full(len(p), c, np.int32))
                parts_i.append(np.arange(len(p), dtype=np.int32))
            pos = np.concatenate(parts_p)
            lane_arr = np.concatenate(parts_l)
            idx = np.concatenate(parts_i)
            order = np.argsort(pos, kind="stable")
            stop_table = (pos[order], lane_arr[order], idx[order])
        pos, lane_arr, idx = stop_table
        m = lane_arr > ci
        return pos[m], lane_arr[m], idx[m]

    ci, j0, mcu_base = 0, 0, 0
    while mcu_base < n_mcus:
        lane = first + ci
        nd = int(n_dec[lane])
        o = int(m0[lane])
        a = mcu_bits[lane, o: o + nd + 1]
        sync = None
        if ci + 1 < k:
            nxt = first + ci + 1
            b = mcu_bits[nxt, int(m0[nxt]):
                         int(m0[nxt]) + int(n_dec[nxt]) + 1]
            # First recorded position common to this lane (at/after its
            # handoff index) and its successor. Positions are strictly
            # increasing per lane, so the smallest common value is the
            # earliest sync in both.
            common, ai, bi = np.intersect1d(
                a[j0:], b, return_indices=True)
            if len(common):
                sync = (j0 + int(ai[0]), int(bi[0]))
        if sync is not None:
            take = sync[0] - j0
            if take < 0 or mcu_base + take > n_mcus:
                return None  # mis-sync past segment end: corruption
        else:
            # Broken link or final lane: keep everything this lane
            # verified (overlap MCUs included), then bridge on the host.
            take = min(nd - j0, n_mcus - mcu_base)
            if take < 0:
                return None
        rows = lane * cap + o + np.arange(j0, j0 + take)
        src[mcu_base: mcu_base + take] = rows
        corr[mcu_base: mcu_base + take] = (
            base - dc_cum[lane, o + j0]).astype(np.int32)
        base = (base + dc_cum[lane, o + j0 + take].astype(np.int64)
                - dc_cum[lane, o + j0])
        mcu_base += take
        if sync is not None:
            ci, j0 = ci + 1, sync[1]
            continue
        if mcu_base >= n_mcus:
            break
        gap = _host_gap_decode(
            plan, int(a[j0 + take]), base, later_stops(ci),
            n_mcus - mcu_base, seg.byte_end)
        if gap is None:
            return None
        g_blocks, base, resume, g = gap
        if g:
            patch_mcus.extend(range(mcu_base, mcu_base + g))
            patch_blocks.append(g_blocks.reshape(g * bpm, 64))
            gap_mcus += g
            mcu_base += g
        if resume is None:
            break
        ci, j0 = resume
    if mcu_base != n_mcus:
        return None
    return src, corr, patch_mcus, patch_blocks, gap_mcus


@lru_cache(maxsize=64)
def _compiled_relocate(bpm: int, slot_comp: tuple):
    @jax.jit
    def relocate(out_flat, src_rows, corr):
        """out_flat [S*cap, bpm*64]; src_rows [n_mcus]; corr [n_mcus,
        n_comp] -> [n_mcus*bpm, 64] stream-ordered, DC-corrected."""
        rows = out_flat[src_rows]
        n = src_rows.shape[0]
        rows = rows.reshape(n, bpm, 64)
        for slot in range(bpm):
            rows = rows.at[:, slot, 0].add(corr[:, slot_comp[slot]])
        return rows.reshape(n * bpm, 64)

    return relocate


def decode_coefficients_device_spec(plan: DecodePlan, target_lanes=2048,
                                    overlap_mcus=OVERLAP_MCUS, luts=None,
                                    pair=False):
    """Speculative chunk-lane entropy decode ->
    ([total_blocks, 64] i32 on device, stats dict) or (None, stats) when
    a sync chain broke (caller falls back to the host tier).

    ``stats`` records lanes / cap / merge outcome for gate measurement.
    ``pair`` selects the pair-symbol precomputed-value LUT kernel
    (:mod:`jpeg_tpu.entropy.device_pair`) over the v2 single-symbol one.
    """
    segs = plan.segments
    bpm = plan.blocks_per_mcu
    if pair:
        slot_comp, slot_dc, slot_ac = _plan_pair_ids(plan)
    else:
        slot_comp, slot_dc, slot_ac = _plan_slot_ids(plan)
    lane_start, lane_chunk_end, lane_seg_end, groups = _chunk_lanes(
        plan, target_lanes)
    S = len(lane_start)
    max_chunk_mcus = 0
    for s, first, k in groups:
        # Byte chunks equalize bits, not MCUs: allow ~30% density skew
        # over the fair share. Lockstep cost IS the iteration count, so
        # cap stays tight; a lane that genuinely needs more ends early
        # and gap recovery patches the difference.
        fair = -(-s.mcu_count // k)
        max_chunk_mcus = max(max_chunk_mcus,
                             min(s.mcu_count, (fair * 13 + 9) // 10 + 2))
    cap = max_chunk_mcus + overlap_mcus

    kernel = _compiled_spec_kernel(
        len(plan.components), cap, slot_comp, slot_dc, slot_ac,
        overlap_mcus, pair)
    if luts is None:
        if pair:
            from jpeg_tpu.entropy.device_pair import pair_luts

            luts_arr = jnp.asarray(pair_luts(plan)[0])
        else:
            luts_arr = jnp.asarray(packed_luts(plan))
    else:
        luts_arr = luts
    out, mcu_bits, dc_cum, n_dec = kernel(
        jnp.asarray((_scan_words2 if pair else _scan_words)(
            plan.scan_data)), luts_arr,
        jnp.asarray(lane_start), jnp.asarray(lane_chunk_end),
        jnp.asarray(lane_seg_end))

    # Control arrays to host (~1% of coefficient volume).
    mcu_bits_h = np.asarray(mcu_bits)
    dc_cum_h = np.asarray(dc_cum)
    n_dec_h = np.asarray(n_dec)
    m0_h = np.zeros(S, np.int32)

    stats = {"lanes": S, "cap": cap, "merged": 0, "failed": 0,
             "gap_mcus": 0}
    srcs, corrs = [], []
    patch_rows, patch_blocks = [], []
    mcu_off = 0
    for s, first, k in groups:
        m = _merge_segment(plan, s, first, k, mcu_bits_h, dc_cum_h,
                           n_dec_h, m0_h, cap, len(plan.components))
        if m is None:
            stats["failed"] += 1
            return None, stats
        stats["merged"] += 1
        src_s, corr_s, pm, pb, gaps = m
        stats["gap_mcus"] += gaps
        srcs.append(src_s)
        corrs.append(corr_s)
        for mi in pm:
            patch_rows.extend(
                range((mcu_off + mi) * bpm, (mcu_off + mi + 1) * bpm))
        patch_blocks.extend(pb)
        mcu_off += s.mcu_count
    src_rows = np.concatenate(srcs)
    corr = np.concatenate(corrs)

    relocate = _compiled_relocate(bpm, slot_comp)
    coeffs = relocate(
        out.reshape(S * cap, bpm * 64),
        jnp.asarray(src_rows.astype(np.int32)), jnp.asarray(corr))
    coeffs = coeffs[: plan.total_blocks]
    if patch_rows:
        coeffs = coeffs.at[jnp.asarray(np.array(patch_rows, np.int32))
                           ].set(jnp.asarray(np.concatenate(patch_blocks)))
    return coeffs, stats
