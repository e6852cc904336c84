"""Device-side parallel entropy decode: one lane per restart segment.

The reference's entropy decode is strictly sequential — one global bit cursor
(``src/jpeg/huffman.rs:231-254``) and cross-scan DC prediction
(``src/jpeg/decoder.rs:207-210``). Restart markers break both chains (JPEG
F.2.1.3.1): every segment starts byte-aligned with DC predictors reset. This
module exploits that on the device (SURVEY.md §7 layer 4, after
"Accelerating JPEG Decompression on GPUs", arXiv 2111.09219): all segments
decode *in lockstep*, one Huffman symbol per lane per step, vectorized over
[S]-shaped state — no data-dependent Python control flow, static shapes,
everything on device.

Loop structure (no vector scatters with data-dependent indices: only
elementwise updates and scalar-index slice updates):

  fori over MCUs
    static Python unroll over the MCU's block slots  (component/table ids
      become compile-time constants -> LUT row index is static)
      while any lane still inside this block: decode ONE symbol per lane
        - bit window: one pair of adjacent u32-word gathers covers code +
          magnitude bits (27 max)
        - symbol: one [S] gather from the slot's static LUT row
        - coefficient write: one-hot(pos) accumulate into a [S, 64] block
          accumulator (pure elementwise)
      flush accumulator into out[:, mcu*bpm+slot] via dynamic_update_slice
      (scalar index -> fast path)

Cost: one lockstep step per Huffman symbol per lane, dominated by the
random gathers of the bit window and the one-hot coefficient accumulate
over [S, 64]. The lanes do ~1 coefficient of regular work per step, so the
threaded C++ host decoder (:mod:`jpeg_tpu.runtime`) is the production
default and ``device_path_profitable`` gates this one. Not yet measured on
the GPU.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from jpeg_tpu.io.container import DecodePlan

# Combined LUT layout: row t = table, t in [0..3] DC, [4..7] AC.
# Entry packs (value << 8) | code_length; length 0 = invalid prefix.


def packed_luts(plan: DecodePlan) -> np.ndarray:
    """[8, 65536] int32 packed (value<<8)|length for DC0-3, AC0-3."""
    rows = []
    for t in list(plan.dc_tables) + list(plan.ac_tables):
        rows.append(
            (t.lut_value.astype(np.int32) << 8) | t.lut_length.astype(np.int32)
        )
    return np.stack(rows)


@lru_cache(maxsize=64)
def _compiled_kernel(n_comp: int, max_mcus: int,
                     slot_comp: tuple, slot_dc: tuple, slot_ac: tuple):
    """Build the jitted lockstep decoder for a (geometry, table-binding)
    class. slot_* are static per-MCU-slot component/table ids, so all LUT row
    selections below are compile-time."""
    bpm = len(slot_comp)
    blocks_per_seg = max_mcus * bpm
    # Termination backstop for corrupt streams: a block never needs more than
    # 1 DC + 63 AC symbols + 1 EOB.
    max_block_steps = 65

    def kernel(data_w32, luts, bit_start, bit_end, n_blocks_seg):
        """data_w32: [n_words] uint32 big-endian packed scan bytes
        (0xAA-padded tail); luts: [8, 65536] i32; bit_start/bit_end/
        n_blocks_seg: [S] i32. Returns (coeffs [S, blocks_per_seg, 64] i32
        zigzag, DC-predicted; error [S] bool).

        A symbol needs at most 16 (code) + 11 (magnitude) = 27 bits, so ONE
        pair of adjacent u32 words per step provides a 32-bit window covering
        both the LUT peek and the magnitude bits — 2 gathers per step instead
        of 6 byte gathers (HBM random gathers dominate this kernel's cost).
        """
        S = bit_start.shape[0]
        n_words = data_w32.shape[0]
        pos_iota = jax.lax.broadcasted_iota(jnp.int32, (S, 64), 1)

        def window32(cursor):
            """32 bits starting at absolute bit `cursor` (uint32)."""
            word_i = jnp.clip(cursor >> 5, 0, n_words - 2)
            off = (cursor & 31).astype(jnp.uint32)
            w0 = data_w32[word_i]
            w1 = data_w32[word_i + 1]
            hi = w0 << off
            lo = jnp.where(off > 0, w1 >> (jnp.uint32(32) - off), jnp.uint32(0))
            return hi | lo

        def sign_extend(v, n):
            base = jnp.where(n > 0, 1 << jnp.maximum(n - 1, 0), 0)
            return jnp.where((n > 0) & (v < base), v - 2 * base + 1, v)

        def decode_block(cursor, err, active, lut_dc, lut_ac):
            """Lockstep-decode one block on all active lanes.

            Returns (block [S, 64] with raw DC delta at 0, cursor, err).
            """
            acc = jnp.zeros((S, 64), jnp.int32)
            # coef: 0 = expect DC, 1..63 next AC position, >=64 done.
            state = dict(
                cursor=cursor, err=err, coef=jnp.zeros((S,), jnp.int32),
                acc=acc, step=jnp.int32(0),
            )

            def cond(st):
                busy = active & ~st["err"] & (st["coef"] < 64)
                return (st["step"] < max_block_steps) & jnp.any(busy)

            def body(st):
                busy = active & ~st["err"] & (st["coef"] < 64)
                is_dc = st["coef"] == 0
                win = window32(st["cursor"])
                peek = (win >> 16).astype(jnp.int32)
                e_dc = lut_dc[peek]
                e_ac = lut_ac[peek]
                entry = jnp.where(is_dc, e_dc, e_ac)
                length = entry & 0xFF
                sym = (entry >> 8) & 0xFF
                bad = busy & (length == 0)
                cur1 = st["cursor"] + length

                is_eob = (~is_dc) & (sym == 0x00)
                is_zrl = (~is_dc) & (sym == 0xF0)
                run = (sym >> 4) & 0xF
                size = jnp.where(is_dc, sym, sym & 0xF)
                nbits = jnp.where(is_eob | is_zrl, 0, size)
                # Magnitude bits from the same window: bits
                # [length, length+nbits) of `win`.
                sh = (jnp.uint32(32) - (length + nbits).astype(jnp.uint32))
                raw = jnp.where(
                    nbits > 0,
                    ((win >> sh).astype(jnp.int32)
                     & ((1 << jnp.minimum(nbits, 16)) - 1)),
                    0,
                )
                val = sign_extend(raw, nbits)
                cur2 = cur1 + nbits

                run_cap = jnp.minimum(run, 64 - st["coef"] - 1)
                pos = jnp.where(is_dc, 0, st["coef"] + run_cap)
                coef_next = jnp.where(
                    is_dc, 1,
                    jnp.where(
                        is_eob, 64,
                        jnp.where(is_zrl, jnp.minimum(st["coef"] + 16, 64),
                                  pos + 1)))
                do_write = busy & ~bad & ~is_eob & ~is_zrl
                # One-hot coefficient write: pure elementwise, no scatter.
                acc = st["acc"] + jnp.where(
                    do_write[:, None] & (pos_iota == pos[:, None]),
                    val[:, None], 0)
                return dict(
                    cursor=jnp.where(busy & ~bad, cur2, st["cursor"]),
                    err=st["err"] | bad,
                    coef=jnp.where(busy & ~bad, coef_next, st["coef"]),
                    acc=acc,
                    step=st["step"] + 1,
                )

            st = jax.lax.while_loop(cond, body, state)
            # A lane that exhausted the step budget mid-block is corrupt.
            err2 = st["err"] | (active & (st["coef"] < 64) & ~st["err"] & (
                st["step"] >= max_block_steps))
            return st["acc"], st["cursor"], err2

        def mcu_body(m, carry):
            cursor, err, prev_dc, out = carry
            base = m * bpm
            for slot in range(bpm):
                comp = slot_comp[slot]
                lut_dc = luts[slot_dc[slot]]
                lut_ac = luts[4 + slot_ac[slot]]
                active = ~err & (base + slot < n_blocks_seg)
                block, cursor, err = decode_block(
                    cursor, err, active, lut_dc, lut_ac)
                dc = jnp.where(active, block[:, 0] + prev_dc[comp], prev_dc[comp])
                prev_dc = tuple(
                    dc if c == comp else prev_dc[c] for c in range(n_comp)
                )
                block = block.at[:, 0].set(jnp.where(active, dc, 0))
                block = jnp.where(active[:, None], block, 0)
                out = jax.lax.dynamic_update_slice(
                    out, block[:, None, :], (0, base + slot, 0))
            return cursor, err, prev_dc, out

        out = jnp.zeros((S, blocks_per_seg, 64), jnp.int32)
        prev_dc = tuple(jnp.zeros((S,), jnp.int32) for _ in range(n_comp))
        cursor = bit_start
        err = jnp.zeros((S,), bool)
        cursor, err, prev_dc, out = jax.lax.fori_loop(
            0, max_mcus, mcu_body, (cursor, err, prev_dc, out))
        # Cursor overrun check: a well-formed segment never reads more than a
        # whole padding byte past its end.
        err = err | (cursor > bit_end + 8)
        return out, err

    return jax.jit(kernel)


def decode_coefficients_device(plan: DecodePlan, luts=None):
    """Entropy-decode the scan on the device -> ([total_blocks, 64] i32, err [S]).

    Output contract identical to the oracle/C++ decoders (zigzag order, DC
    prediction applied, MCU stream order). Segments must be uniform
    (``restart_interval`` MCUs each, last possibly short) — guaranteed by
    :func:`jpeg_tpu.io.container.parse_jpeg`.
    """
    segs = plan.segments
    S = len(segs)
    bpm = plan.blocks_per_mcu
    max_mcus = max(s.mcu_count for s in segs)
    slots = plan.component_block_slots()
    slot_comp = tuple(ci for ci, _ in slots)
    slot_dc = tuple(plan.components[ci].dc_id for ci, _ in slots)
    slot_ac = tuple(plan.components[ci].ac_id for ci, _ in slots)

    kernel = _compiled_kernel(
        len(plan.components), max_mcus, slot_comp, slot_dc, slot_ac)
    # Pack scan bytes into big-endian u32 words, 0xAA-padded (see kernel doc).
    n_bytes = len(plan.scan_data)
    n_words = -(-n_bytes // 4) + 2
    padded = np.full(n_words * 4, 0xAA, np.uint8)
    padded[:n_bytes] = plan.scan_data
    w = padded.reshape(-1, 4).astype(np.uint32)
    words = (w[:, 0] << 24) | (w[:, 1] << 16) | (w[:, 2] << 8) | w[:, 3]
    luts_arr = jnp.asarray(packed_luts(plan)) if luts is None else luts
    out, err = kernel(
        jnp.asarray(words),
        luts_arr,
        jnp.asarray(np.array([s.byte_start * 8 for s in segs], np.int32)),
        jnp.asarray(np.array([s.byte_end * 8 for s in segs], np.int32)),
        jnp.asarray(np.array([s.mcu_count * bpm for s in segs], np.int32)),
    )
    coeffs = out.reshape(S * max_mcus * bpm, 64)[: plan.total_blocks]
    return coeffs, err


def decode_coefficients_device_batch(plans: list, luts=None):
    """Lane-batched entropy decode of a CORPUS on the device.

    VERDICT r1 item 1a: a single 4K stream has ~135 restart segments —
    far too few lanes for the lockstep decoder. Batching images stacks all
    their segments on the lane axis (S_total = sum of per-image segments),
    so the per-step vector work amortizes over thousands of lanes while
    the sequential step count stays that of ONE image's longest segment.

    Requirements (the homogeneous-corpus deployment shape): every plan
    shares the same slot structure/table bindings and byte-identical
    Huffman tables (same encoder settings), and segments are uniform per
    image. Returns (list of [total_blocks, 64] i32 per image, err [S]).
    """
    assert plans, "empty batch"
    p0 = plans[0]
    slots = p0.component_block_slots()
    slot_comp = tuple(ci for ci, _ in slots)
    slot_dc = tuple(p0.components[ci].dc_id for ci, _ in slots)
    slot_ac = tuple(p0.components[ci].ac_id for ci, _ in slots)
    luts0 = packed_luts(p0)
    for p in plans[1:]:
        s = p.component_block_slots()
        if (tuple(ci for ci, _ in s) != slot_comp
                or tuple(p.components[ci].dc_id for ci, _ in s) != slot_dc
                or tuple(p.components[ci].ac_id for ci, _ in s) != slot_ac
                or not np.array_equal(packed_luts(p), luts0)):
            raise ValueError(
                "device batch requires identical slot structure and "
                "Huffman tables across images")
    max_mcus = max(s.mcu_count for p in plans for s in p.segments)
    bpm = p0.blocks_per_mcu

    # Concatenate scan bytes, each image padded to a word boundary so the
    # shared big-endian u32 word array serves every lane.
    bufs = []
    img_base = []
    pos = 0
    for p in plans:
        img_base.append(pos)
        n = len(p.scan_data)
        padded_len = -(-n // 4) * 4
        buf = np.full(padded_len, 0xAA, np.uint8)
        buf[:n] = p.scan_data
        bufs.append(buf)
        pos += padded_len
    allbytes = np.concatenate(bufs + [np.full(8, 0xAA, np.uint8)])
    w = allbytes.reshape(-1, 4).astype(np.uint32)
    words = (w[:, 0] << 24) | (w[:, 1] << 16) | (w[:, 2] << 8) | w[:, 3]

    bit_start = []
    bit_end = []
    n_blocks_seg = []
    for p, base in zip(plans, img_base):
        for s in p.segments:
            bit_start.append((base + s.byte_start) * 8)
            bit_end.append((base + s.byte_end) * 8)
            n_blocks_seg.append(s.mcu_count * bpm)

    kernel = _compiled_kernel(
        len(p0.components), max_mcus, slot_comp, slot_dc, slot_ac)
    out, err = kernel(
        jnp.asarray(words),
        jnp.asarray(luts0) if luts is None else luts,
        jnp.asarray(np.array(bit_start, np.int32)),
        jnp.asarray(np.array(bit_end, np.int32)),
        jnp.asarray(np.array(n_blocks_seg, np.int32)),
    )
    flat = out.reshape(-1, max_mcus * bpm, 64)
    results = []
    row = 0
    for p in plans:
        segs = p.segments
        if all(s.mcu_count == max_mcus for s in segs[:-1]):
            img = flat[row : row + len(segs)].reshape(-1, 64)[: p.total_blocks]
        else:
            # This image's restart interval is shorter than the batch-wide
            # max: per-segment rows carry internal padding, trim each.
            parts = [
                flat[row + i, : s.mcu_count * bpm]
                for i, s in enumerate(segs)
            ]
            img = jnp.concatenate(parts)[: p.total_blocks]
        results.append(img)
        row += len(segs)
    return results, err


def device_path_profitable(plan: DecodePlan,
                           min_segments: int | None = None) -> bool:
    """Gate for routing entropy decode to the device lane decoders.

    Defaults to "never": every lockstep formulation in this package needs
    thousands of dependent steps per 4K scan, and none beat the threaded
    C++ host tier on the hardware it was measured on. Nothing has been
    measured on the GPU yet (ROADMAP Queue 1, device entropy); pass an
    explicit ``min_segments`` measured on your host:device ratio to route
    to the device.
    """
    if min_segments is None:
        return False
    return len(plan.segments) >= min_segments
