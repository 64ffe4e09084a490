"""The port's Zstandard decoder (``anomalyclip_tpu_torch/utils/zstd.py``)
against frames the ``zstandard`` package writes (used here only, as the
encoder).

- Every case decodes to its input byte for byte: levels 1, 3 and 19, with and
  without the content checksum, on seeded fp32 and bf16 arrays, int64, text,
  zeros (RLE), random bytes, copies that leave one literal byte value, and
  inputs from empty to past 128 KB (several blocks); two frames concatenated,
  and a skippable frame between them.
- Across those cases the decoder takes every path it has: raw, RLE, Huffman
  (one and four streams) and treeless literals, direct and FSE-coded Huffman
  weights, predefined, RLE, FSE-described and repeated sequence tables.
- A frame naming a dictionary, a damaged checksum and a truncated frame raise.
- XXH64 against the published values, and hypothesis-drawn bytes.
"""

from __future__ import annotations

import numpy as np
import pytest
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from anomalyclip_tpu_torch.utils import zstd

LEVELS = (1, 3, 19)


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    weights = (rng.standard_normal(40_000, dtype=np.float32) * np.float32(0.02))
    bf16 = (rng.standard_normal(70_000, dtype=np.float32).view(np.uint32) >> 16).astype(np.uint16)
    words = [b"anomaly", b"clip", b"frame", b"segment", b"score", b"video", b"the", b"of"]
    text = b" ".join(words[i] for i in rng.integers(0, len(words), 30_000))
    base = rng.integers(0, 256, 100_000, dtype=np.uint8).tobytes()
    return {
        "empty": b"",
        "one_byte": b"x",
        "fp32": weights.tobytes(),
        "bf16": bf16.tobytes(),
        "int64": np.arange(-40_000, 40_000, 3, dtype=np.int64).tobytes(),
        "text": text,
        "zeros": bytes(200_000),
        "random": rng.integers(0, 256, 150_000, dtype=np.uint8).tobytes(),
        "four_symbols": rng.integers(0, 4, 140_000, dtype=np.uint8).tobytes(),
        # random bytes, then copies of them each after an "x": at level 19 the
        # second block's literals are all "x" (RLE literals)
        "one_literal": base + b"".join(b"x" + base[p:p + 60] for p in rng.integers(0, 99_000, 1500)),
    }


INPUTS = _inputs()


@pytest.mark.parametrize("checksum", [False, True], ids=["plain", "checksum"])
@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_decodes_what_zstandard_wrote(name, level, checksum):
    data = INPUTS[name]
    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(data)
    assert zstd.decompress(frame) == data


def _header_size(frame: bytes) -> int:
    fhd = frame[4]
    single = (fhd >> 5) & 1
    return 5 + (not single) + (0, 1, 2, 4)[fhd & 3] + (single, 2, 4, 8)[fhd >> 6]


def _blocks(frame: bytes) -> int:
    pos, n = _header_size(frame), 0
    while True:
        header = int.from_bytes(frame[pos:pos + 3], "little")
        n += 1
        pos += 3 + (1 if (header >> 1) & 3 == 1 else header >> 3)
        if header & 1:
            return n


def test_inputs_reach_past_one_block():
    for name in ("fp32", "bf16", "int64", "zeros", "random", "four_symbols"):
        assert len(INPUTS[name]) > 128 * 1024, name
        assert _blocks(zstandard.ZstdCompressor(level=1).compress(INPUTS[name])) > 1, name


def test_concatenated_and_skippable_frames():
    a, b = INPUTS["text"][:5000], INPUTS["fp32"][:70_000]
    skippable = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
    c1 = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(a)
    c2 = zstandard.ZstdCompressor(level=1).compress(b)
    assert zstd.decompress(c1 + c2) == a + b
    assert zstd.decompress(c1 + skippable + c2) == a + b


def test_every_decoding_path_is_taken(monkeypatch):
    seen = set()
    literals, weights, table = zstd._literals, zstd._huffman_weights, zstd._sequence_table

    def spy_literals(data, pos, end, state):
        kind, size_format = data[pos] & 3, (data[pos] >> 2) & 3
        seen.add(("literals", ("raw", "rle", "huffman", "treeless")[kind]))
        if kind >= 2:
            seen.add(("streams", 1 if size_format == 0 else 4))
        return literals(data, pos, end, state)

    def spy_weights(data, pos, end):
        seen.add(("weights", "direct" if data[pos] >= 128 else "fse"))
        return weights(data, pos, end)

    def spy_table(name, mode, data, pos, end, state):
        seen.add(("table", ("predefined", "rle", "fse", "repeat")[mode]))
        return table(name, mode, data, pos, end, state)

    monkeypatch.setattr(zstd, "_literals", spy_literals)
    monkeypatch.setattr(zstd, "_huffman_weights", spy_weights)
    monkeypatch.setattr(zstd, "_sequence_table", spy_table)
    for data in INPUTS.values():
        for level in LEVELS:
            assert zstd.decompress(zstandard.ZstdCompressor(level=level).compress(data)) == data
    want = {("literals", k) for k in ("raw", "rle", "huffman", "treeless")}
    want |= {("streams", 1), ("streams", 4), ("weights", "direct"), ("weights", "fse")}
    want |= {("table", k) for k in ("predefined", "rle", "fse", "repeat")}
    assert want <= seen, want - seen


def test_refuses_dictionaries_bad_checksums_and_truncation():
    data = INPUTS["text"][:20_000]
    with pytest.raises(zstd.ZstdError, match="dictionary"):
        zstd.decompress(_with_dictionary_id(zstandard.ZstdCompressor(level=3).compress(data)))
    frame = bytearray(zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data))
    frame[-1] ^= 1
    with pytest.raises(zstd.ZstdError, match="checksum"):
        zstd.decompress(bytes(frame))
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(bytes(frame[: len(frame) // 2]))
    with pytest.raises(zstd.ZstdError, match="not a Zstandard frame"):
        zstd.decompress(b"\x00" * 16)


def _with_dictionary_id(frame: bytes) -> bytes:
    """``frame`` with a one-byte dictionary id (7) put into its header, after
    the window descriptor where it has one."""
    fhd = frame[4]
    assert fhd & 3 == 0
    at = 6 if not (fhd >> 5) & 1 else 5
    return frame[:4] + bytes([fhd | 1]) + frame[5:at] + b"\x07" + frame[at:]


def test_xxh64_published_values():
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    assert zstd.xxh64(b"a") == 0xD24EC4F1A98C6E5B
    assert zstd.xxh64(b"abc") == 0x44BC2CF5AD770999
    data = bytes(range(256)) * 3
    frame = zstandard.ZstdCompressor(level=1, write_checksum=True).compress(data)
    assert int.from_bytes(frame[-4:], "little") == zstd.xxh64(data) & 0xFFFFFFFF


@settings(max_examples=60, deadline=None)
@given(data=st.binary(max_size=5000), level=st.sampled_from(LEVELS), checksum=st.booleans(),
       repeat=st.integers(1, 40))
def test_random_bytes_round_trip(data, level, checksum, repeat):
    payload = data * repeat
    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(payload)
    assert zstd.decompress(frame) == payload
