"""Device entropy decode v2: register-refill multi-symbol lockstep lanes.

Redesign of :mod:`jpeg_tpu.entropy.device_decode` (v1) around a lockstep
cost model in which a step pays per dependent gather and per chained
elementwise op, not per byte touched: a dynamic [S]-lane gather costs
about the same whatever the table size, and a few dozen fused [S]
elementwise ops cost about one gather.

Design consequences:

1. **Per-lane 96-bit bit register** (three u32s, left-aligned): each
   lockstep step does at most two *conditional word refills* (one [S]
   gather each) — a lane holding <= 64 valid bits appends the next whole
   u32 of its stream. Sustained input is 64 bits/step — several typical
   Huffman symbols from TWO gathers, versus v1's 2 window gathers per
   single symbol.

2. **Flat-LUT symbol resolution** (one [65536]-row gather per symbol).
   A gather-free "canonical" resolution (code length via 16 vector
   compares + [S, 256] one-hot over HUFFVAL — the arithmetic form of the
   reference's per-length linear scan, ``src/jpeg/huffman.rs:211-227``)
   was built and compared: its ~50-op chain costs about what the gather
   it replaces does, and the flat LUT won the full-kernel comparison —
   op count, not bytes touched, is what a step pays for.

3. **DC peeled, 6 AC symbols per step.** Within a block the first symbol
   is DC and the rest are AC, so DC decodes ahead of the while loop (no
   per-lane table select) and each loop step retires up to
   ``SYMS_PER_STEP`` AC symbols, each gated on >= 27 valid register bits
   (16 code + 11 magnitude worst case). After the refills every lane
   holds >= 64 valid bits, so >= 2 symbols always retire per busy step
   and the corrupt-stream backstop is 34 steps.

Contract identical to v1 (tested for equivalence against the oracle):
zigzag order, DC prediction applied, MCU stream order, per-lane error
flags. Reference behavior contract: ``src/jpeg/huffman.rs:109-268``.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from jpeg_tpu.entropy.device_decode import packed_luts
from jpeg_tpu.io.container import DecodePlan

# AC symbols retired per lockstep step (each gated on register bits).
# Wider steps amortize the per-iteration cost until gated-skip waste takes
# over; 6 was the best of 4, 6 and 8 where it was first swept.
SYMS_PER_STEP = 6


def _scan_words(scan_bytes: np.ndarray | bytes) -> np.ndarray:
    """Big-endian u32 words of the 0xAA-padded scan (+2 pad words so the
    refill gather may fetch ahead of the final segment's tail)."""
    b = np.frombuffer(bytes(scan_bytes), np.uint8)
    n_words = -(-len(b) // 4) + 2
    padded = np.full(n_words * 4, 0xAA, np.uint8)
    padded[: len(b)] = b
    w = padded.reshape(-1, 4).astype(np.uint32)
    return (w[:, 0] << 24) | (w[:, 1] << 16) | (w[:, 2] << 8) | w[:, 3]


def _make_register_ops(words, u32=jnp.uint32):
    """(refill, consume) closures over the scan-word array: the per-lane
    96-bit register is a tuple (wi, cnt, hi, mi, lo) — next word index,
    valid-bit count, three left-aligned u32s."""
    n_words = words.shape[0]

    def refill(reg):
        """One conditional word refill: lanes holding <= 64 valid bits
        append words[wi] at bit position cnt (one gather)."""
        wi, cnt, hi, mi, lo = reg
        w = words[jnp.clip(wi, 0, n_words - 1)]
        can = cnt <= 64
        cu = cnt.astype(u32)
        sh_a = cu & u32(31)
        hi_c = jnp.where(cnt < 32, w >> sh_a, u32(0))
        mi_c = jnp.where(
            cnt == 0, u32(0),
            jnp.where(cnt < 32, w << ((u32(32) - cu) & u32(31)),
                      jnp.where(cnt < 64, w >> ((cu - u32(32)) & u32(31)),
                                u32(0))))
        lo_c = jnp.where((cnt >= 33) & (cnt <= 64),
                         w << ((u32(64) - cu) & u32(31)), u32(0))
        hi = jnp.where(can, hi | hi_c, hi)
        mi = jnp.where(can, mi | mi_c, mi)
        lo = jnp.where(can, lo | lo_c, lo)
        wi = wi + can.astype(jnp.int32)
        cnt = cnt + 32 * can.astype(jnp.int32)
        return (wi, cnt, hi, mi, lo)

    def consume(reg, d):
        """Shift the 96-bit register left by d (< 32) bits."""
        wi, cnt, hi, mi, lo = reg
        du = d.astype(u32)
        dsh = (u32(32) - du) & u32(31)
        dnz = du > 0
        hi = jnp.where(dnz, (hi << du) | (mi >> dsh), hi)
        mi = jnp.where(dnz, (mi << du) | (lo >> dsh), mi)
        lo = jnp.where(dnz, lo << du, lo)
        return (wi, cnt - d, hi, mi, lo)

    return refill, consume


def _scan_words2(scan_bytes: np.ndarray | bytes) -> np.ndarray:
    """[2, n_words] u32: column i = (word i, word i+1) so one refill
    appends 64 bits from two flat gathers off static slices (a row
    gather lowers badly on this stack)."""
    w = _scan_words(scan_bytes)
    nxt = np.roll(w, -1)
    nxt[-1] = 0xAAAAAAAA
    return np.stack([w, nxt])


def _make_register_ops64(words2, u32=jnp.uint32):
    """(refill64, consume) over a [2, n_words] word-pair array: refill64
    appends TWO stream words (64 bits) when the lane holds <= 32 valid
    bits."""
    n_words = words2.shape[1]

    def refill64(reg):
        wi, cnt, hi, mi, lo = reg
        wic = jnp.clip(wi, 0, n_words - 1)
        w0 = words2[0][wic]
        w1 = words2[1][wic]
        can = cnt <= 32
        cu = cnt.astype(u32)
        sh = cu & u32(31)
        full = cnt == 32  # w0 lands entirely in mi, w1 in lo
        hi_c = jnp.where(full, u32(0), w0 >> sh)
        mi_c = jnp.where(full, w0,
                         jnp.where(cnt == 0, u32(0),
                                   w0 << ((u32(32) - cu) & u32(31))))
        mi_c = mi_c | jnp.where(full, u32(0), w1 >> sh)
        lo_c = jnp.where(full, w1,
                         jnp.where(cnt == 0, u32(0),
                                   w1 << ((u32(32) - cu) & u32(31))))
        hi = jnp.where(can, hi | hi_c, hi)
        mi = jnp.where(can, mi | mi_c, mi)
        lo = jnp.where(can, lo | lo_c, lo)
        wi = wi + 2 * can.astype(jnp.int32)
        cnt = cnt + 64 * can.astype(jnp.int32)
        return (wi, cnt, hi, mi, lo)

    def consume(reg, d):
        wi, cnt, hi, mi, lo = reg
        du = d.astype(u32)
        dsh = (u32(32) - du) & u32(31)
        dnz = du > 0
        hi = jnp.where(dnz, (hi << du) | (mi >> dsh), hi)
        mi = jnp.where(dnz, (mi << du) | (lo >> dsh), mi)
        lo = jnp.where(dnz, lo << du, lo)
        return (wi, cnt - d, hi, mi, lo)

    return refill64, consume


def _sign_extend(v, n):
    """JPEG Table F.2 receive-and-extend."""
    base = jnp.where(n > 0, 1 << jnp.maximum(n - 1, 0), 0)
    return jnp.where((n > 0) & (v < base), v - 2 * base + 1, v)


def _magnitude(hi, length, nbits, u32=jnp.uint32):
    """Magnitude bits [length, length+nbits) of the register top (<= 31
    bits total: all within ``hi``), sign-extended."""
    sh = (u32(32) - (length + nbits).astype(u32))
    raw = jnp.where(
        nbits > 0,
        ((hi >> sh).astype(jnp.int32)
         & ((1 << jnp.minimum(nbits, 16)) - 1)), 0)
    return _sign_extend(raw, nbits)


def _make_block_decoder(refill, consume, S):
    """Build decode_block(reg, err, active, lut_dc, lut_ac) ->
    (block [S, 64] raw-DC, reg, err): lockstep-decode one block on all
    active lanes — DC peeled, then up to SYMS_PER_STEP AC symbols per
    while-step on two refill gathers. Shared by the restart-lane kernel
    below and the speculative chunk-lane kernel
    (:mod:`jpeg_tpu.entropy.device_spec`)."""
    pos_iota = jax.lax.broadcasted_iota(jnp.int32, (S, 64), 1)
    max_block_steps = 34  # >= 2 AC symbols retire per busy step

    def decode_block(reg, err, active, lut_dc, lut_ac):
        # --- DC: peeled (exactly one symbol, its own table).
        reg = refill(refill(reg))
        peek = (reg[2] >> 16).astype(jnp.int32)
        e = lut_dc[peek]
        length = e & 0xFF
        nbits = (e >> 8) & 0xFF
        bad = active & (length == 0)
        val = _magnitude(reg[2], length, nbits)
        ok = active & ~bad
        reg = consume(reg, jnp.where(ok, length + nbits, 0))
        acc = jnp.where(ok[:, None] & (pos_iota == 0), val[:, None], 0)
        state = dict(
            reg=reg, err=err | bad,
            coef=jnp.where(ok, 1, 64), acc=acc, step=jnp.int32(0),
        )

        def cond(st):
            busy = active & ~st["err"] & (st["coef"] < 64)
            return (st["step"] < max_block_steps) & jnp.any(busy)

        def body(st):
            reg = refill(refill(st["reg"]))
            err, coef, acc = st["err"], st["coef"], st["acc"]
            for _k in range(SYMS_PER_STEP):
                busy = (active & ~err & (coef < 64) & (reg[1] >= 31))
                peek = (reg[2] >> 16).astype(jnp.int32)
                e = lut_ac[peek]
                length = e & 0xFF
                sym = (e >> 8) & 0xFF
                bad = busy & (length == 0)
                is_eob = sym == 0x00
                is_zrl = sym == 0xF0
                run = (sym >> 4) & 0xF
                size = sym & 0xF
                nbits = jnp.where(is_eob | is_zrl, 0, size)
                val = _magnitude(reg[2], length, nbits)
                d = jnp.where(busy & ~bad, length + nbits, 0)

                run_cap = jnp.minimum(run, 64 - coef - 1)
                pos = coef + run_cap
                coef_next = jnp.where(
                    is_eob, 64,
                    jnp.where(is_zrl, jnp.minimum(coef + 16, 64),
                              pos + 1))
                do_write = busy & ~bad & ~is_eob & ~is_zrl
                acc = acc + jnp.where(
                    do_write[:, None] & (pos_iota == pos[:, None]),
                    val[:, None], 0)
                coef = jnp.where(busy & ~bad, coef_next, coef)
                err = err | bad
                reg = consume(reg, d)
            return dict(reg=reg, err=err, coef=coef, acc=acc,
                        step=st["step"] + 1)

        st = jax.lax.while_loop(cond, body, state)
        err2 = st["err"] | (active & (st["coef"] < 64) & (
            st["step"] >= max_block_steps))
        return st["acc"], st["reg"], err2

    return decode_block


def _pair_iter_factory(consume, S):
    """Shared pair-entry iteration for the pair-LUT block decoders."""
    pos_iota = jax.lax.broadcasted_iota(jnp.int32, (S, 64), 1)

    def pair_iter(reg, err, active, coef, acc, lut):
        """One pair-entry iteration: gate, gather, apply 1-2 symbols,
        consume. Consumes <= 31 bits (12-bit slow path worst case:
        16-bit code + 15 magnitude bits, covered by the reg[1] >= 31
        refill guard)."""
        busy = active & ~err & (coef < 64) & (reg[1] >= 31)
        peek = (reg[2] >> 16).astype(jnp.int32)
        # lut is [2, 65536] (A-word row, B-word row): two flat gathers
        # from static slices, not one [65536, 2] row gather.
        eA = lut[0][peek]
        eB = lut[1][peek]
        mode = eA & 3
        f1 = (eA >> 2) & 0x3F
        adv1 = (eA >> 8) & 0xFF
        w1 = ((eA >> 16) & 1) == 1
        v1 = (eA >> 17) & 0x1FFF
        slow = mode == 2
        size_s = v1 & 0x1F
        val_slow = _magnitude(reg[2], f1, jnp.where(slow, size_s, 0))
        val1 = jnp.where(slow, val_slow, v1 - ((v1 >> 12) << 13))
        bad = busy & (mode == 3)
        ok = busy & ~bad
        pos1 = jnp.minimum(coef + adv1 - 1, 63)
        do1 = ok & w1
        acc = acc + jnp.where(do1[:, None] & (pos_iota == pos1[:, None]),
                              val1[:, None], 0)
        coef1 = jnp.minimum(coef + adv1, 64)
        adv2 = eB & 0xFF
        w2 = ((eB >> 8) & 1) == 1
        v2 = (eB >> 9) & 0x1FFF
        val2 = v2 - ((v2 >> 12) << 13)
        have2 = ok & (mode == 1) & (coef1 < 64)
        # Consumed bits: slow adds its magnitude; a pair whose second
        # symbol is unused (sym1 filled the block) consumes c1 only.
        c = jnp.where(slow, f1 + size_s, f1)
        c = jnp.where((mode == 1) & ~have2, (eB >> 22) & 0x1F, c)
        pos2 = jnp.minimum(coef1 + adv2 - 1, 63)
        do2 = have2 & w2
        acc = acc + jnp.where(do2[:, None] & (pos_iota == pos2[:, None]),
                              val2[:, None], 0)
        coef2 = jnp.where(have2, jnp.minimum(coef1 + adv2, 64), coef1)
        coef = jnp.where(ok, coef2, coef)
        err = err | bad
        reg = consume(reg, jnp.where(ok, c, 0))
        return reg, err, coef, acc

    return pair_iter


def _make_block_decoder_pair(refill, consume, S):
    """Pair-LUT block decoder (same contract as
    :func:`_make_block_decoder`): tables are [65536, 2] i32 pair-entry
    rows (:mod:`jpeg_tpu.entropy.device_pair`) — one gather retires up
    to TWO symbols with values precomputed, collapsing the per-symbol
    magnitude/sign/run op chain into table unpacking. Two pair
    iterations per while-step on two refill gathers."""
    pair_iter = _pair_iter_factory(consume, S)
    max_block_steps = 34  # >= 2 symbols retire per busy step

    def decode_block(reg, err, active, lut_dc, lut_ac):
        # DC iteration peeled: the DC pair table also retires the first
        # AC symbol (a DC+EOB block finishes in one gather).
        reg = refill(refill(reg))
        acc = jnp.zeros((S, 64), jnp.int32)
        coef = jnp.where(active, 0, 64)
        reg, err, coef, acc = pair_iter(reg, err, active, coef, acc,
                                        lut_dc)
        state = dict(reg=reg, err=err, coef=coef, acc=acc,
                     step=jnp.int32(0))

        def cond(st):
            busy = active & ~st["err"] & (st["coef"] < 64)
            return (st["step"] < max_block_steps) & jnp.any(busy)

        def body(st):
            reg = refill(refill(st["reg"]))
            err, coef, acc = st["err"], st["coef"], st["acc"]
            for _k in range(2):
                reg, err, coef, acc = pair_iter(
                    reg, err, coef < 64, coef, acc, lut_ac)
            return dict(reg=reg, err=err, coef=coef, acc=acc,
                        step=st["step"] + 1)

        st = jax.lax.while_loop(cond, body, state)
        err2 = st["err"] | (active & (st["coef"] < 64) & (
            st["step"] >= max_block_steps))
        return st["acc"], st["reg"], err2

    return decode_block


def _make_block_decoder_pair_lean(refill64, consume, S):
    """Gather-op-minimal pair-LUT block decoder: ONE 64-bit refill row
    gather per step (``_make_register_ops64``) feeding two pair
    iterations, and a DC step of refill64 + one DC-pair gather. Each
    dependent gather op costs about the same regardless of lane count,
    so ops-per-block is the whole cost model: this decoder
    averages ~6-7 gather ops per block vs ~12-15 for the v2 single-
    symbol decoder. A step whose first iteration leaves < 27 valid bits
    skips the second iteration and refills next step (refill64 only
    fires at <= 32 bits, so progress is guaranteed)."""
    pair_iter = _pair_iter_factory(consume, S)
    max_block_steps = 20  # >= 4 syms/busy step + gated-refill skips

    def decode_block(reg, err, active, lut_dc, lut_ac):
        reg = refill64(reg)
        acc = jnp.zeros((S, 64), jnp.int32)
        coef = jnp.where(active, 0, 64)
        reg, err, coef, acc = pair_iter(reg, err, active, coef, acc,
                                        lut_dc)
        state = dict(reg=reg, err=err, coef=coef, acc=acc,
                     step=jnp.int32(0))

        def cond(st):
            busy = active & ~st["err"] & (st["coef"] < 64)
            return (st["step"] < max_block_steps) & jnp.any(busy)

        def body(st):
            # Wide step: with thousands of lockstep lanes the worst
            # lane's step count gates every block, so fewer/wider
            # iterations beat lean ones (measured ladder in the module
            # docstring). Two gated refills bound input at 128 bits.
            reg = refill64(st["reg"])
            err, coef, acc = st["err"], st["coef"], st["acc"]
            for _k in range(4):
                if _k == 2:
                    reg = refill64(reg)
                reg, err, coef, acc = pair_iter(
                    reg, err, coef < 64, coef, acc, lut_ac)
            return dict(reg=reg, err=err, coef=coef, acc=acc,
                        step=st["step"] + 1)

        st = jax.lax.while_loop(cond, body, state)
        err2 = st["err"] | (active & (st["coef"] < 64) & (
            st["step"] >= max_block_steps))
        return st["acc"], st["reg"], err2

    return decode_block


@lru_cache(maxsize=64)
def _compiled_kernel2(n_comp: int, max_mcus: int,
                      slot_comp: tuple, slot_dc: tuple, slot_ac: tuple,
                      pair: bool = False):
    """Jitted register-refill decoder for one (geometry, table-binding)
    class. Loop skeleton as v1: fori over MCUs, static slot unroll,
    while-over-steps, one-hot coefficient accumulate, scalar-indexed
    output flush. With ``pair=True`` the tables are pair-entry rows
    (:mod:`jpeg_tpu.entropy.device_pair`) and slot_dc/slot_ac index the
    stacked pair-table rows directly."""
    bpm = len(slot_comp)
    blocks_per_seg = max_mcus * bpm

    def kernel(words, luts, bit_start, bit_end, n_blocks_seg):
        """words: [n_words] u32 big-endian scan words; luts: [8, 65536]
        i32 packed (value<<8)|length rows (DC 0-3, AC 4-7), or
        [2K, 65536, 2] pair rows when ``pair``; bit_start/bit_end/
        n_blocks_seg: [S] i32. Returns (coeffs
        [S, blocks_per_seg, 64] i32 zigzag, DC-predicted; error [S])."""
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

        def mcu_body(m, carry):
            reg, err, prev_dc, out = carry
            base = m * bpm
            for slot in range(bpm):
                comp = slot_comp[slot]
                lut_dc = luts[slot_dc[slot]]
                lut_ac = luts[slot_ac[slot] if pair
                              else 4 + slot_ac[slot]]
                active = ~err & (base + slot < n_blocks_seg)
                block, reg, err = decode_block(
                    reg, err, active, lut_dc, lut_ac)
                dc = jnp.where(
                    active, block[:, 0] + prev_dc[comp], prev_dc[comp])
                prev_dc = tuple(
                    dc if c == comp else prev_dc[c] for c in range(n_comp))
                block = block.at[:, 0].set(jnp.where(active, dc, 0))
                block = jnp.where(active[:, None], block, 0)
                out = jax.lax.dynamic_update_slice(
                    out, block[:, None, :], (0, base + slot, 0))
            return reg, err, prev_dc, out

        # Register init: load the lane's first word, pre-discard the
        # sub-word bit offset of its byte-aligned start.
        wi0 = bit_start >> 5
        off0 = (bit_start & 31).astype(u32)
        w0 = (words[0] if pair else words)[jnp.clip(wi0, 0, n_words - 1)]
        reg = (wi0 + 1, 32 - (bit_start & 31), w0 << off0,
               jnp.zeros((S,), u32), jnp.zeros((S,), u32))
        out = jnp.zeros((S, blocks_per_seg, 64), jnp.int32)
        prev_dc = tuple(jnp.zeros((S,), jnp.int32) for _ in range(n_comp))
        err = jnp.zeros((S,), bool)
        reg, err, prev_dc, out = jax.lax.fori_loop(
            0, max_mcus, mcu_body, (reg, err, prev_dc, out))
        # Cursor overrun check: consumed bits = fetched - register balance
        # (refill prefetch advances wi and cnt equally, so this is the
        # true consumed position). Well-formed segments never consume more
        # than one whole padding byte past their end.
        cursor = reg[0] * 32 - reg[1]
        err = err | (cursor > bit_end + 8)
        return out, err

    return jax.jit(kernel)


def _plan_slot_ids(plan: DecodePlan):
    slots = plan.component_block_slots()
    return (tuple(ci for ci, _ in slots),
            tuple(plan.components[ci].dc_id for ci, _ in slots),
            tuple(plan.components[ci].ac_id for ci, _ in slots))


def decode_coefficients_device2(plan: DecodePlan, luts=None):
    """Entropy-decode the scan on the device (v2 kernel) ->
    ([total_blocks, 64] i32, err [S]). Contract identical to v1
    (:func:`jpeg_tpu.entropy.device_decode.decode_coefficients_device`)."""
    segs = plan.segments
    bpm = plan.blocks_per_mcu
    max_mcus = max(s.mcu_count for s in segs)
    slot_comp, slot_dc, slot_ac = _plan_slot_ids(plan)
    kernel = _compiled_kernel2(
        len(plan.components), max_mcus, slot_comp, slot_dc, slot_ac)
    luts_arr = jnp.asarray(packed_luts(plan)) if luts is None else luts
    out, err = kernel(
        jnp.asarray(_scan_words(plan.scan_data)),
        luts_arr,
        jnp.asarray(np.array([s.byte_start * 8 for s in segs], np.int32)),
        jnp.asarray(np.array([s.byte_end * 8 for s in segs], np.int32)),
        jnp.asarray(np.array([s.mcu_count * bpm for s in segs], np.int32)),
    )
    S = len(segs)
    coeffs = out.reshape(S * max_mcus * bpm, 64)[: plan.total_blocks]
    return coeffs, err


def _plan_pair_ids(plan: DecodePlan):
    """(slot_comp, dc_row, ac_row) for the stacked pair-table rows."""
    from jpeg_tpu.entropy.device_pair import pair_luts

    _luts, slot_pair = pair_luts(plan)
    slots = plan.component_block_slots()
    return (tuple(ci for ci, _ in slots),
            tuple(2 * p for p in slot_pair),
            tuple(2 * p + 1 for p in slot_pair))


def decode_coefficients_device3(plan: DecodePlan, luts=None):
    """Entropy-decode the scan on the device with the pair-symbol
    precomputed-value LUT kernel -> ([total_blocks, 64] i32, err [S]).
    Contract identical to v2."""
    from jpeg_tpu.entropy.device_pair import pair_luts

    segs = plan.segments
    bpm = plan.blocks_per_mcu
    max_mcus = max(s.mcu_count for s in segs)
    slot_comp, dc_row, ac_row = _plan_pair_ids(plan)
    kernel = _compiled_kernel2(
        len(plan.components), max_mcus, slot_comp, dc_row, ac_row,
        pair=True)
    luts_arr = jnp.asarray(pair_luts(plan)[0]) if luts is None else luts
    out, err = kernel(
        jnp.asarray(_scan_words2(plan.scan_data)),
        luts_arr,
        jnp.asarray(np.array([s.byte_start * 8 for s in segs], np.int32)),
        jnp.asarray(np.array([s.byte_end * 8 for s in segs], np.int32)),
        jnp.asarray(np.array([s.mcu_count * bpm for s in segs], np.int32)),
    )
    S = len(segs)
    coeffs = out.reshape(S * max_mcus * bpm, 64)[: plan.total_blocks]
    return coeffs, err


def decode_coefficients_device2_batch(plans: list):
    """Lane-batched corpus decode on the v2 kernel (see v1
    ``decode_coefficients_device_batch`` for the batching contract)."""
    assert plans, "empty batch"
    p0 = plans[0]
    ids0 = _plan_slot_ids(p0)
    luts0 = packed_luts(p0)
    for p in plans[1:]:
        if (_plan_slot_ids(p) != ids0
                or not np.array_equal(packed_luts(p), luts0)):
            raise ValueError(
                "device batch requires identical slot structure and "
                "Huffman tables across images")
    slot_comp, slot_dc, slot_ac = ids0
    max_mcus = max(s.mcu_count for p in plans for s in p.segments)
    bpm = p0.blocks_per_mcu

    bufs = []
    img_base = []
    pos = 0
    for p in plans:
        img_base.append(pos)
        n = len(p.scan_data)
        padded_len = -(-n // 4) * 4
        buf = np.full(padded_len, 0xAA, np.uint8)
        buf[:n] = np.frombuffer(bytes(p.scan_data), np.uint8)
        bufs.append(buf)
        pos += padded_len
    allbytes = np.concatenate(bufs)

    bit_start, bit_end, n_blocks_seg = [], [], []
    for p, base in zip(plans, img_base):
        for s in p.segments:
            bit_start.append((base + s.byte_start) * 8)
            bit_end.append((base + s.byte_end) * 8)
            n_blocks_seg.append(s.mcu_count * bpm)

    kernel = _compiled_kernel2(
        len(p0.components), max_mcus, slot_comp, slot_dc, slot_ac)
    out, err = kernel(
        jnp.asarray(_scan_words(allbytes)),
        jnp.asarray(luts0),
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
            img = flat[row: row + len(segs)].reshape(-1, 64)[: p.total_blocks]
        else:
            parts = [flat[row + i, : s.mcu_count * bpm]
                     for i, s in enumerate(segs)]
            img = jnp.concatenate(parts)[: p.total_blocks]
        results.append(img)
        row += len(segs)
    return results, err
