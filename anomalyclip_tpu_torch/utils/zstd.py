"""A Zstandard decoder (RFC 8878) in Python and numpy.

The JAX package's Orbax checkpoints compress every B-tree node, manifest and
zarr chunk with Zstandard. ``decompress`` turns a buffer of one or more frames
back into its content, with no compression package:

- frames: the header (window, dictionary id, content size, checksum flag), raw,
  RLE and compressed blocks, the XXH64 content checksum when the frame carries
  one; skippable frames are skipped. A frame that names a dictionary is refused.
- literals: raw, RLE, Huffman-coded in one or four streams, and treeless (the
  previous block's table), with the tree described by direct or FSE-coded weights.
- sequences: predefined, RLE, FSE-described and repeated tables, the three
  repeat offsets, and their execution into a ``bytearray``.

It is table-driven. A Huffman stream is decoded from one lookup table on a
``max_bits``-wide window: numpy reads the window at every bit position at
once, and a Python loop follows the code lengths from the end of the stream,
four symbols a step. The FSE-coded sequences take one Python step a sequence over a
backward bit reader. A match is copied as a slice.

It never imports a compression package, even where one is installed, so what
it reads it reads the same way everywhere.
"""

from __future__ import annotations

import numpy as np

FRAME_MAGIC = 0xFD2FB528
_SKIPPABLE_MASK, _SKIPPABLE_MAGIC = 0xFFFFFFF0, 0x184D2A50
_BLOCK_MAX = 1 << 17


class ZstdError(ValueError):
    """A buffer that is not a valid Zstandard frame, or needs what this
    decoder does not read (a dictionary)."""


# ---------------------------------------------------------------------------
# bit readers
# ---------------------------------------------------------------------------


class _BackwardBits:
    """The bits of ``data[start:end]`` read from the last one down, as RFC 8878
    writes its FSE and Huffman streams: the highest set bit of the last byte
    marks the end, and what lies past the first byte reads as zeros.
    ``overflow`` counts the bits read past the first byte."""

    __slots__ = ("data", "start", "pos", "acc", "n", "overflow")

    def __init__(self, data, start: int, end: int):
        if end <= start:
            raise ZstdError("empty bitstream")
        last = data[end - 1]
        if last == 0:
            raise ZstdError("bitstream without its end mark")
        self.data, self.start, self.pos = data, start, end - 1
        self.n = last.bit_length() - 1
        self.acc = last & ((1 << self.n) - 1)
        self.overflow = 0

    def read(self, k: int) -> int:
        if k == 0:
            return 0
        if self.n < k:
            take = min(8, self.pos - self.start)
            if take:
                self.acc = (self.acc << (8 * take)) | int.from_bytes(
                    self.data[self.pos - take:self.pos], "little")
                self.n += 8 * take
                self.pos -= take
            if self.n < k:  # past the first byte: zeros
                short = k - self.n
                self.overflow += short
                value = self.acc << short
                self.acc, self.n = 0, 0
                return value
        self.n -= k
        value = self.acc >> self.n
        self.acc &= (1 << self.n) - 1
        return value

    def finished(self) -> bool:
        """Every bit read, none past the first byte."""
        return self.n == 0 and self.pos == self.start and self.overflow == 0


class _ForwardBits:
    """Little-endian bits from ``data[pos:]`` (the FSE table descriptions)."""

    __slots__ = ("value", "bit", "limit")

    def __init__(self, data, pos: int, end: int):
        self.value = int.from_bytes(data[pos:end], "little")
        self.bit, self.limit = 0, 8 * (end - pos)

    def peek(self, k: int) -> int:
        return (self.value >> self.bit) & ((1 << k) - 1)

    def skip(self, k: int) -> None:
        self.bit += k
        if self.bit > self.limit:
            raise ZstdError("table description runs past its block")

    def read(self, k: int) -> int:
        value = self.peek(k)
        self.skip(k)
        return value


# ---------------------------------------------------------------------------
# FSE tables
# ---------------------------------------------------------------------------


def _read_fse_counts(data, pos: int, end: int, max_log: int, max_symbol: int):
    """An FSE table description at ``data[pos:end]`` -> (accuracy log, the
    normalized counts, the bytes it took). A count of -1 is a probability
    below one."""
    bits = _ForwardBits(data, pos, min(end, pos + 1024))
    log = bits.read(4) + 5
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} over its limit {max_log}")
    remaining = (1 << log) + 1
    threshold, nbits = 1 << log, log + 1
    counts: list = []
    previous_zero = False
    while remaining > 1:
        if previous_zero:
            while True:
                repeat = bits.read(2)
                counts.extend([0] * repeat)
                if repeat != 3:
                    break
        if len(counts) > max_symbol:
            raise ZstdError("FSE table description names too many symbols")
        limit = 2 * threshold - 1 - remaining
        low = bits.peek(nbits - 1)
        if low < limit:
            value = low
            bits.skip(nbits - 1)
        else:
            value = bits.peek(nbits)
            if value >= threshold:
                value -= limit
            bits.skip(nbits)
        count = value - 1
        remaining -= abs(count)
        counts.append(count)
        previous_zero = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(counts) > max_symbol + 1:
        raise ZstdError("corrupt FSE table description")
    return log, counts, (bits.bit + 7) // 8


def _fse_table(log: int, counts) -> tuple:
    """Normalized counts -> the decoding table as three lists indexed by
    state: symbol, bits to read, and the base the read bits are added to."""
    size = 1 << log
    symbols = [0] * size
    high = size - 1
    next_state = [0] * len(counts)
    for s, c in enumerate(counts):
        if c == -1:
            symbols[high] = s
            high -= 1
            next_state[s] = 1
        else:
            next_state[s] = c
    step, mask, pos = (size >> 1) + (size >> 3) + 3, size - 1, 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbols[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ZstdError("FSE counts do not fill their table")
    nbits, base = [0] * size, [0] * size
    for u in range(size):
        s = symbols[u]
        x = next_state[s]
        next_state[s] += 1
        nb = log - (x.bit_length() - 1)
        nbits[u], base[u] = nb, (x << nb) - size
    return symbols, nbits, base, log


def _rle_table(symbol: int) -> tuple:
    return [symbol], [0], [0], 0


# RFC 8878 section 3.1.1.3.2.2: the predefined distributions
_LL_DEFAULT = (4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1,
               1, 1, -1, -1, -1, -1)
_ML_DEFAULT = (1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1)
_OF_DEFAULT = (1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1)
_PREDEFINED = {
    "ll": _fse_table(6, _LL_DEFAULT),
    "ml": _fse_table(6, _ML_DEFAULT),
    "of": _fse_table(5, _OF_DEFAULT),
}
# (max accuracy log, largest symbol) of each sequence table
_SEQ_LIMITS = {"ll": (9, 35), "of": (8, 31), "ml": (9, 52)}

_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096,
                              8192, 16384, 32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051,
                                 4099, 8195, 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]


# ---------------------------------------------------------------------------
# Huffman literals
# ---------------------------------------------------------------------------


def _huffman_weights(data, pos: int, end: int):
    """The tree description at ``data[pos:]`` -> (the weights it states, the
    bytes it took)."""
    header = data[pos]
    if header >= 128:  # direct: 4 bits a weight
        n = header - 127
        size = 1 + (n + 1) // 2
        if pos + size > end:
            raise ZstdError("Huffman weights run past their block")
        packed = data[pos + 1:pos + size]
        weights = [(packed[i // 2] >> 4) if i % 2 == 0 else (packed[i // 2] & 15) for i in range(n)]
        return weights, size
    size = 1 + header  # FSE-coded weights, decoded by two interleaved states
    if pos + size > end:
        raise ZstdError("Huffman weights run past their block")
    log, counts, used = _read_fse_counts(data, pos + 1, pos + size, 6, 255)
    symbols, nbits, base, _ = _fse_table(log, counts)
    bits = _BackwardBits(data, pos + 1 + used, pos + size)
    s1, s2 = bits.read(log), bits.read(log)
    weights: list = []
    while True:
        if len(weights) > 255:
            raise ZstdError("too many Huffman weights")
        weights.append(symbols[s1])
        s1 = base[s1] + bits.read(nbits[s1])
        if bits.overflow:
            weights.append(symbols[s2])
            break
        weights.append(symbols[s2])
        s2 = base[s2] + bits.read(nbits[s2])
        if bits.overflow:
            weights.append(symbols[s1])
            break
    return weights, size


def _huffman_table(weights) -> tuple:
    """Stated weights (the last symbol's implied) -> (symbol and code length
    at every ``max_bits``-bit window, as numpy arrays, and max_bits)."""
    if any(w > 11 for w in weights):
        raise ZstdError("Huffman weight over 11")
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise ZstdError("Huffman tree without weights")
    max_bits = total.bit_length()
    left = (1 << max_bits) - total
    if left & (left - 1):
        raise ZstdError("Huffman weights do not sum to a power of two")
    weights = list(weights) + [left.bit_length()]
    if max_bits > 11:
        raise ZstdError(f"Huffman code of {max_bits} bits")
    size = 1 << max_bits
    syms = np.zeros(size, np.uint8)
    lengths = np.zeros(size, np.int32)
    pos = 0
    for w in range(1, max(weights) + 1):
        span = 1 << (w - 1)
        for s, ws in enumerate(weights):
            if ws == w:
                syms[pos:pos + span] = s
                lengths[pos:pos + span] = max_bits + 1 - w
                pos += span
    if pos != size:
        raise ZstdError("Huffman weights do not fill their table")
    return syms, lengths, max_bits


_PAD = 2  # zero bytes below a stream: what is read past its first byte
_JUMP = 4  # symbols the Python step of a Huffman stream walks at once


def _huffman_stream(data, start: int, end: int, count: int, table) -> np.ndarray:
    """``count`` symbols from the Huffman stream ``data[start:end]``.

    The stream is read from its end down. numpy takes the ``max_bits``-wide
    window at every bit position, its symbol and its code length, and from
    them where the next symbol starts and where the one ``_JUMP`` symbols on
    does; the Python loop then walks the stream ``_JUMP`` symbols a step, and
    numpy fills in the starts between."""
    syms, lengths, max_bits = table
    if end <= start or data[end - 1] == 0:
        raise ZstdError("Huffman stream without its end mark")
    raw = np.frombuffer(bytes(_PAD) + bytes(data[start:end]) + bytes(2), np.uint8)
    n = len(raw) - 2
    # the window whose lowest bit is bit 8k + s, for every byte k and shift s
    words = raw[:n].astype(np.uint32) | (raw[1:n + 1].astype(np.uint32) << 8) | (
        raw[2:n + 2].astype(np.uint32) << 16)
    windows = ((words[:, None] >> np.arange(8, dtype=np.uint32)) & ((1 << max_bits) - 1)).ravel()
    # the window start of the next symbol; none lies below bit 0 on a valid
    # stream, so clamping there only keeps a damaged one in range
    after = np.arange(len(windows), dtype=np.int32)
    after -= np.take(lengths, windows)
    np.maximum(after, 0, out=after)
    jump = after
    for _ in range(_JUMP.bit_length() - 1):
        jump = np.take(jump, jump)
    top = 8 * (_PAD + end - start - 1) + data[end - 1].bit_length() - 1
    low = 8 * _PAD - max_bits  # the window start once every bit is read
    at = top - max_bits
    strides, tail = divmod(count, _JUMP)
    heads = [0] * strides
    hop = memoryview(jump)
    for i in range(strides):
        heads[i] = at
        at = hop[at]
    starts = [np.asarray(heads, np.int32)]
    for _ in range(_JUMP - 1):
        starts.append(np.take(after, starts[-1]))
    step = memoryview(after)
    rest = [0] * tail
    for i in range(tail):
        rest[i] = at
        at = step[at]
    if at != low:
        raise ZstdError("Huffman stream does not end on its last symbol")
    order = np.concatenate([np.stack(starts, axis=1).ravel(), np.asarray(rest, np.int32)])
    return np.take(syms, np.take(windows, order))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


class _FrameState:
    """What a frame's blocks hand on: the last Huffman table, the last
    sequence tables, the repeat offsets."""

    __slots__ = ("huffman", "tables", "offsets")

    def __init__(self):
        self.huffman = None
        self.tables = {"ll": None, "of": None, "ml": None}
        self.offsets = [1, 4, 8]


def _literals(data, pos: int, end: int, state: _FrameState):
    """The literals section at ``data[pos:end]`` -> (its literals, the
    position after it)."""
    b0 = data[pos]
    kind, size_format = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):  # raw, RLE
        if size_format in (0, 2):
            size, pos = b0 >> 3, pos + 1
        elif size_format == 1:
            size, pos = (b0 >> 4) + (data[pos + 1] << 4), pos + 2
        else:
            size, pos = (b0 >> 4) + (data[pos + 1] << 4) + (data[pos + 2] << 12), pos + 3
        if size > _BLOCK_MAX:
            raise ZstdError("literals over the block limit")
        if kind == 0:
            if pos + size > end:
                raise ZstdError("raw literals run past their block")
            return bytes(data[pos:pos + size]), pos + size
        if pos >= end:
            raise ZstdError("RLE literals run past their block")
        return bytes([data[pos]]) * size, pos + 1
    # compressed (2) or treeless (3)
    if size_format in (0, 1):
        header, width, head = int.from_bytes(data[pos:pos + 3], "little"), 10, 3
    elif size_format == 2:
        header, width, head = int.from_bytes(data[pos:pos + 4], "little"), 14, 4
    else:
        header, width, head = int.from_bytes(data[pos:pos + 5], "little"), 18, 5
    mask = (1 << width) - 1
    regenerated, compressed = (header >> 4) & mask, (header >> (4 + width)) & mask
    streams = 1 if size_format == 0 else 4
    pos += head
    stop = pos + compressed
    if stop > end or regenerated > _BLOCK_MAX:
        raise ZstdError("compressed literals run past their block")
    if kind == 2:
        weights, used = _huffman_weights(data, pos, stop)
        state.huffman = _huffman_table(weights)
        pos += used
    elif state.huffman is None:
        raise ZstdError("treeless literals with no earlier Huffman table")
    table = state.huffman
    if streams == 1:
        out = _huffman_stream(data, pos, stop, regenerated, table)
    else:
        if pos + 6 > stop:
            raise ZstdError("Huffman jump table runs past its literals")
        s1, s2, s3 = (int.from_bytes(data[pos + 2 * i:pos + 2 * i + 2], "little") for i in range(3))
        bounds = [pos + 6, pos + 6 + s1, pos + 6 + s1 + s2, pos + 6 + s1 + s2 + s3, stop]
        if bounds[3] > stop:
            raise ZstdError("Huffman streams run past their literals")
        seg = (regenerated + 3) // 4
        sizes = [seg, seg, seg, regenerated - 3 * seg]
        if sizes[3] < 0:
            raise ZstdError("too few literals for four streams")
        out = np.concatenate([_huffman_stream(data, bounds[i], bounds[i + 1], sizes[i], table)
                              for i in range(4)])
    return out.tobytes(), stop


def _sequence_table(name: str, mode: int, data, pos: int, end: int, state: _FrameState):
    if mode == 0:
        table, used = _PREDEFINED[name], 0
    elif mode == 1:
        if pos >= end:
            raise ZstdError("RLE sequence table runs past its block")
        table, used = _rle_table(data[pos]), 1
    elif mode == 2:
        max_log, max_symbol = _SEQ_LIMITS[name]
        log, counts, used = _read_fse_counts(data, pos, end, max_log, max_symbol)
        table = _fse_table(log, counts)
    else:
        table, used = state.tables[name], 0
        if table is None:
            raise ZstdError(f"repeated {name} table with no earlier one")
    state.tables[name] = table
    return table, pos + used


def _compressed_block(data, pos: int, end: int, out: bytearray, frame_start: int,
                      state: _FrameState) -> None:
    literals, pos = _literals(data, pos, end, state)
    if pos >= end:
        raise ZstdError("block without its sequences section")
    b0 = data[pos]
    if b0 == 0:
        if pos + 1 != end:
            raise ZstdError("bytes after an empty sequences section")
        out += literals
        return
    if b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        nseq, pos = ((b0 - 128) << 8) + data[pos + 1], pos + 2
    else:
        nseq, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
    modes = data[pos]
    if modes & 3:
        raise ZstdError("reserved bits set in the sequence modes")
    pos += 1
    ll_table, pos = _sequence_table("ll", modes >> 6, data, pos, end, state)
    of_table, pos = _sequence_table("of", (modes >> 4) & 3, data, pos, end, state)
    ml_table, pos = _sequence_table("ml", (modes >> 2) & 3, data, pos, end, state)
    ll_sym, ll_nb, ll_base, ll_log = ll_table
    of_sym, of_nb, of_base, of_log = of_table
    ml_sym, ml_nb, ml_base, ml_log = ml_table
    bits = _BackwardBits(data, pos, end)
    read = bits.read
    ll_state, of_state, ml_state = read(ll_log), read(of_log), read(ml_log)
    rep = state.offsets
    lit = 0
    nlit = len(literals)
    for i in range(nseq):
        of_code, ll_code, ml_code = of_sym[of_state], ll_sym[ll_state], ml_sym[ml_state]
        if of_code > 31:
            raise ZstdError("offset code over 31")
        offset_value = (1 << of_code) + read(of_code)
        match = _ML_BASE[ml_code] + read(_ML_BITS[ml_code])
        literal = _LL_BASE[ll_code] + read(_LL_BITS[ll_code])
        if offset_value > 3:
            offset = offset_value - 3
            rep[2], rep[1], rep[0] = rep[1], rep[0], offset
        else:
            index = offset_value if literal else offset_value + 1
            if index == 1:
                offset = rep[0]
            elif index == 2:
                offset = rep[1]
                rep[1], rep[0] = rep[0], offset
            else:
                offset = rep[2] if index == 3 else rep[0] - 1
                rep[2], rep[1], rep[0] = rep[1], rep[0], offset
        if i != nseq - 1:
            ll_state = ll_base[ll_state] + read(ll_nb[ll_state])
            ml_state = ml_base[ml_state] + read(ml_nb[ml_state])
            of_state = of_base[of_state] + read(of_nb[of_state])
        if lit + literal > nlit:
            raise ZstdError("a sequence takes more literals than the block has")
        out += literals[lit:lit + literal]
        lit += literal
        src = len(out) - offset
        if offset <= 0 or src < frame_start:
            raise ZstdError(f"match offset {offset} before the frame's start")
        if offset >= match:
            out += out[src:src + match]
        else:  # the match overlaps what it writes: the last `offset` bytes repeat
            out += (out[src:] * (match // offset + 1))[:match]
    if not bits.finished():
        raise ZstdError("sequences bitstream not consumed exactly")
    out += literals[lit:]


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------


def _frame(data, pos: int, out: bytearray) -> int:
    """Decode the frame whose header starts at ``data[pos]`` (after the magic)
    into ``out`` -> the position after it."""
    n = len(data)
    if pos >= n:
        raise ZstdError("truncated frame header")
    fhd = data[pos]
    pos += 1
    fcs_flag, single, checksum, did_flag = fhd >> 6, (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        raise ZstdError("reserved bit set in the frame header")
    if not single:
        pos += 1  # the window descriptor: the whole output stays addressable here
    did_size = (0, 1, 2, 4)[did_flag]
    dictionary = int.from_bytes(data[pos:pos + did_size], "little")
    pos += did_size
    if dictionary:
        raise ZstdError(f"the frame needs dictionary {dictionary}, which this decoder does not read")
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    content_size = None
    if fcs_size:
        content_size = int.from_bytes(data[pos:pos + fcs_size], "little") + (256 if fcs_size == 2 else 0)
        pos += fcs_size
    frame_start = len(out)
    state = _FrameState()
    while True:
        if pos + 3 > n:
            raise ZstdError("truncated block header")
        header = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last, kind, size = header & 1, (header >> 1) & 3, header >> 3
        if kind == 0:
            if pos + size > n:
                raise ZstdError("raw block runs past the buffer")
            out += data[pos:pos + size]
            pos += size
        elif kind == 1:
            if pos >= n:
                raise ZstdError("RLE block runs past the buffer")
            out += bytes([data[pos]]) * size
            pos += 1
        elif kind == 2:
            if pos + size > n or size > _BLOCK_MAX:
                raise ZstdError("compressed block runs past the buffer")
            _compressed_block(data, pos, pos + size, out, frame_start, state)
            pos += size
        else:
            raise ZstdError("reserved block type")
        if last:
            break
    if content_size is not None and len(out) - frame_start != content_size:
        raise ZstdError(f"frame content is {len(out) - frame_start} bytes, its header says {content_size}")
    if checksum:
        if pos + 4 > n:
            raise ZstdError("truncated content checksum")
        want = int.from_bytes(data[pos:pos + 4], "little")
        got = xxh64(memoryview(out)[frame_start:]) & 0xFFFFFFFF
        if got != want:
            raise ZstdError(f"content checksum {got:08x} does not match the frame's {want:08x}")
        pos += 4
    return pos


def decompress(data) -> bytes:
    """The content of every frame in ``data`` (bytes-like), in order;
    skippable frames are skipped."""
    data = bytes(data)
    out = bytearray()
    pos, n = 0, len(data)
    while pos < n:
        if pos + 4 > n:
            raise ZstdError("trailing bytes after the last frame")
        magic = int.from_bytes(data[pos:pos + 4], "little")
        if magic & _SKIPPABLE_MASK == _SKIPPABLE_MAGIC:
            if pos + 8 > n:
                raise ZstdError("truncated skippable frame")
            pos += 8 + int.from_bytes(data[pos + 4:pos + 8], "little")
            if pos > n:
                raise ZstdError("skippable frame runs past the buffer")
            continue
        if magic != FRAME_MAGIC:
            raise ZstdError(f"not a Zstandard frame at byte {pos} (magic {magic:08x})")
        pos = _frame(data, pos + 4, out)
    return bytes(out)


# ---------------------------------------------------------------------------
# XXH64, for the content checksum
# ---------------------------------------------------------------------------

_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261
_M64 = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data, seed: int = 0) -> int:
    """XXH64 of ``data`` (bytes-like)."""
    data = bytes(data)
    n = len(data)
    i = 0
    if n >= 32:
        v1, v2 = (seed + _P1 + _P2) & _M64, (seed + _P2) & _M64
        v3, v4 = seed & _M64, (seed - _P1) & _M64
        stripes = n // 32
        lanes = np.frombuffer(data, "<u8", count=4 * stripes).tolist()
        for j in range(0, 4 * stripes, 4):
            v1 = _round(v1, lanes[j])
            v2 = _round(v2, lanes[j + 1])
            v3 = _round(v3, lanes[j + 2])
            v4 = _round(v4, lanes[j + 3])
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _M64
        i = 32 * stripes
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        h ^= _round(0, int.from_bytes(data[i:i + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        h ^= (int.from_bytes(data[i:i + 4], "little") * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        i += 4
    while i < n:
        h ^= (data[i] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        i += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    h ^= h >> 32
    return h
