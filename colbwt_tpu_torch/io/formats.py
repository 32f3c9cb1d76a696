"""On-disk interchange codecs (SURVEY §2.4) — the port's copy of
colbwt_tpu/io/formats.py.

Every integer is little-endian.  The reference's widths (RW_BYTES = 5 etc.,
include/common/common.hpp:46-54) are parameters here, defaulting to the same
values.  All codecs are NumPy-vectorized: a 5-byte int vector is decoded with
one reshape + dot, not a Python loop.

File contracts implemented (producer → consumer in the reference pipeline):

- ``.bwt.heads`` / ``.bwt.len``   RLBWT: 1 byte run char + rw_bytes run length
                                  (include/ds/FL_table.hpp:102-115)
- ``.bwt``                        explicit BWT bytes (src/rlbwt_to_bwt.cpp:22-27)
- ``.col_mums``                   rw_bytes num_docs, then (len, pos) pairs
                                  (src/col_split.cpp:90-106)
- ``.thr_pos``                    rw_bytes per BWT run (include/col_bwt.hpp:446-448)
- ``.col_ids``                    id_bytes per set bit of col_runs
                                  (include/col_split.hpp:147-156)
- ``.col_runs``                   sdsl plain bit_vector (include/col_split.hpp:374-390)
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

RW_BYTES = 5


# ---------------------------------------------------------------------------
# fixed-width little-endian integer vectors
# ---------------------------------------------------------------------------

def decode_fixed_ints(buf: bytes | np.ndarray, width: int = RW_BYTES) -> np.ndarray:
    """Decode a packed array of `width`-byte little-endian unsigned ints."""
    raw = np.frombuffer(buf, dtype=np.uint8) if isinstance(buf, (bytes, bytearray)) else buf
    if raw.size % width:
        raise ValueError(f"buffer size {raw.size} not a multiple of width {width}")
    mat = raw.reshape(-1, width).astype(np.uint64)
    weights = (np.uint64(1) << (np.uint64(8) * np.arange(width, dtype=np.uint64)))
    return (mat * weights).sum(axis=1, dtype=np.uint64)


def encode_fixed_ints(values: np.ndarray, width: int = RW_BYTES) -> bytes:
    """Encode unsigned ints as packed `width`-byte little-endian."""
    v = np.asarray(values, dtype=np.uint64)
    if v.size and width < 8 and int(v.max(initial=0)) >= (1 << (8 * width)):
        raise OverflowError(f"value {int(v.max())} does not fit in {width} bytes")
    shifts = np.uint64(8) * np.arange(width, dtype=np.uint64)
    mat = ((v[:, None] >> shifts[None, :]) & np.uint64(0xFF)).astype(np.uint8)
    return mat.tobytes()


def read_fixed_ints(path: str | Path, width: int = RW_BYTES) -> np.ndarray:
    return decode_fixed_ints(Path(path).read_bytes(), width)


def write_fixed_ints(path: str | Path, values: np.ndarray, width: int = RW_BYTES) -> None:
    Path(path).write_bytes(encode_fixed_ints(values, width))


# ---------------------------------------------------------------------------
# RLBWT heads/len  (PREFIX.fa.bwt.heads + PREFIX.fa.bwt.len)
# ---------------------------------------------------------------------------

def read_rlbwt(prefix: str | Path, rw_bytes: int = RW_BYTES) -> tuple[np.ndarray, np.ndarray]:
    """Read (heads, lens): heads uint8 run chars, lens uint64 run lengths."""
    heads = np.frombuffer(Path(f"{prefix}.bwt.heads").read_bytes(), dtype=np.uint8)
    lens = read_fixed_ints(f"{prefix}.bwt.len", rw_bytes)
    if heads.size != lens.size:
        raise ValueError(f"heads ({heads.size}) and lens ({lens.size}) run counts differ")
    return heads, lens


def write_rlbwt(prefix: str | Path, heads: np.ndarray, lens: np.ndarray,
                rw_bytes: int = RW_BYTES) -> None:
    Path(f"{prefix}.bwt.heads").write_bytes(np.asarray(heads, dtype=np.uint8).tobytes())
    write_fixed_ints(f"{prefix}.bwt.len", lens, rw_bytes)


def write_plain_bwt(path: str | Path, heads: np.ndarray, lens: np.ndarray) -> None:
    """Expand RLBWT to the explicit one-byte-per-symbol BWT
    (the rlbwt_to_bwt stage, src/rlbwt_to_bwt.cpp:22-27)."""
    bwt = np.repeat(np.asarray(heads, dtype=np.uint8), np.asarray(lens, dtype=np.int64))
    Path(path).write_bytes(bwt.tobytes())


def read_plain_bwt(path: str | Path) -> np.ndarray:
    return np.frombuffer(Path(path).read_bytes(), dtype=np.uint8)


# ---------------------------------------------------------------------------
# .col_mums  (multi-MUM records)
# ---------------------------------------------------------------------------

def read_col_mums(path: str | Path, rw_bytes: int = RW_BYTES
                  ) -> tuple[int, np.ndarray, np.ndarray]:
    """Returns (num_docs, mum_lens, mum_bwt_pos).

    Layout (src/col_split.cpp:90-106): one rw_bytes uint num_docs, then
    num_mums interleaved (length, bwt_position) rw_bytes pairs.
    """
    vals = read_fixed_ints(path, rw_bytes)
    if vals.size % 2 != 1:
        raise ValueError(f".col_mums has {vals.size} values; expected odd count")
    num_docs = int(vals[0])
    pairs = vals[1:].reshape(-1, 2)
    return num_docs, pairs[:, 0].copy(), pairs[:, 1].copy()


def write_col_mums(path: str | Path, num_docs: int, mum_lens: np.ndarray,
                   mum_pos: np.ndarray, rw_bytes: int = RW_BYTES) -> None:
    lens = np.asarray(mum_lens, dtype=np.uint64)
    pos = np.asarray(mum_pos, dtype=np.uint64)
    vals = np.empty(1 + 2 * lens.size, dtype=np.uint64)
    vals[0] = num_docs
    vals[1::2] = lens
    vals[2::2] = pos
    write_fixed_ints(path, vals, rw_bytes)


# ---------------------------------------------------------------------------
# .thr_pos and .col_ids
# ---------------------------------------------------------------------------

def read_thresholds_file(path: str | Path, rw_bytes: int = RW_BYTES) -> np.ndarray:
    return read_fixed_ints(path, rw_bytes)


def write_thresholds_file(path: str | Path, thresholds: np.ndarray,
                          rw_bytes: int = RW_BYTES) -> None:
    write_fixed_ints(path, thresholds, rw_bytes)


def read_col_ids(path: str | Path, id_bytes: int = 1) -> np.ndarray:
    return read_fixed_ints(path, id_bytes)


def write_col_ids(path: str | Path, ids: np.ndarray, id_bytes: int = 1,
                  id_bits: int = 8) -> np.ndarray:
    """Write per-set-bit col IDs with the reference's modular binning
    ((id % (id_max-1)) + 1 for id >= id_max; include/col_split.hpp:147-156).
    Returns the binned ids."""
    v = np.asarray(ids, dtype=np.uint64)
    id_max = np.uint64(1 << id_bits)
    binned = np.where(v >= id_max, (v % (id_max - np.uint64(1))) + np.uint64(1), v)
    write_fixed_ints(path, binned, id_bytes)
    return binned


# ---------------------------------------------------------------------------
# .col_pml packed-row serialization (the reference alt-path index file)
# ---------------------------------------------------------------------------
# Layout (col_pml::serialize -> col_bwt::serialize -> LF_table::serialize,
# include/col_bwt.hpp:360-380 + include/ds/LF_table.hpp:325-357): bwt_r (8B),
# n (8B), r (8B), size (8B, == r), then r raw 18-byte packed col_thr rows
# (write_vec memcpy of the packed struct, include/common/common.hpp:310-323):
# char:8 idx:40 interval:32 offset:16 col_id:8 threshold:40 bits, LSB-first.

_COL_THR_BYTES = 18


def write_col_pml_file(path: str | Path, *, bwt_r: int, n: int,
                       char: np.ndarray, idx: np.ndarray,
                       dest_interval: np.ndarray, dest_offset: np.ndarray,
                       col_id: np.ndarray, threshold: np.ndarray) -> None:
    r = int(np.asarray(char).size)
    rows = np.zeros((r, _COL_THR_BYTES), dtype=np.uint8)

    def put(field, byte_off, width):
        v = np.asarray(field, dtype=np.uint64)
        if width < 8 and v.size and int(v.max(initial=0)) >= (1 << (8 * width)):
            raise OverflowError(f"field at offset {byte_off} overflows {width}B")
        for b in range(width):
            rows[:, byte_off + b] = ((v >> np.uint64(8 * b)) & np.uint64(0xFF)
                                     ).astype(np.uint8)

    put(char, 0, 1)
    put(idx, 1, 5)            # BWT_BYTES = 5
    put(dest_interval, 6, 4)  # RUN_BYTES = 4
    put(dest_offset, 10, 2)   # LEN_BYTES = 2
    put(col_id, 12, 1)        # ID_BYTES = 1
    put(threshold, 13, 5)     # BWT_BYTES = 5
    header = np.array([bwt_r, n, r, r], dtype="<u8").tobytes()
    Path(path).write_bytes(header + rows.tobytes())


def read_col_pml_file(path: str | Path) -> dict:
    raw = Path(path).read_bytes()
    bwt_r, n, r, size = np.frombuffer(raw[:32], dtype="<u8")
    rows = np.frombuffer(raw[32:32 + int(size) * _COL_THR_BYTES],
                         dtype=np.uint8).reshape(int(size), _COL_THR_BYTES)

    def get(byte_off, width):
        v = np.zeros(rows.shape[0], dtype=np.uint64)
        for b in range(width):
            v |= rows[:, byte_off + b].astype(np.uint64) << np.uint64(8 * b)
        return v

    return {
        "bwt_r": int(bwt_r), "n": int(n), "r": int(r),
        "char": get(0, 1).astype(np.uint8),
        "idx": get(1, 5).astype(np.int64),
        "dest_interval": get(6, 4).astype(np.int64),
        "dest_offset": get(10, 2).astype(np.int64),
        "col_id": get(12, 1).astype(np.uint8),
        "threshold": get(13, 5).astype(np.int64),
    }


# ---------------------------------------------------------------------------
# sdsl plain bit_vector codec
# ---------------------------------------------------------------------------
# sdsl int_vector<1> serialization: a uint64 size-in-bits header followed by
# ceil(bits/64) uint64 data words, bit i of the vector stored at bit (i % 64)
# of word (i // 64).  This is the layout written by bv.serialize(out) for
# .col_runs (include/col_split.hpp:383-387).

def write_sdsl_bit_vector(path: str | Path, bits: np.ndarray) -> None:
    b = np.asarray(bits, dtype=bool)
    n = b.size
    n_words = (n + 63) // 64
    padded = np.zeros(n_words * 64, dtype=bool)
    padded[:n] = b
    # bit i lives at bit (i % 8) of byte (i // 8): LSB-first within each byte,
    # bytes ascending — the little-endian uint64 word layout sdsl writes.
    data = np.packbits(padded, bitorder="little").tobytes()
    header = np.array([n], dtype="<u8").tobytes()
    Path(path).write_bytes(header + data)


def read_sdsl_bit_vector(path: str | Path) -> np.ndarray:
    raw = Path(path).read_bytes()
    n = int(np.frombuffer(raw[:8], dtype="<u8")[0])
    n_words = (n + 63) // 64
    body = np.frombuffer(raw[8:8 + 8 * n_words], dtype=np.uint8)
    flat = np.unpackbits(body, bitorder="little")
    return flat[:n].astype(bool)


# ---------------------------------------------------------------------------
# sdsl sd_vector (Elias-Fano) codec + the .FL_table artifact
# ---------------------------------------------------------------------------
# sd_vector<> serializes (sd_vector.hpp in simongog/sdsl-lite, the library the
# reference fetches at thirdparty/CMakeLists.txt:5-18) as:
#
#   uint64 m_size                 total bit-vector length n
#   uint8  m_wl                   low-bits width = logn - logm
#   int_vector<0> m_low           m values of wl bits each
#   bit_vector    m_high          unary-coded high parts, m + 2**logm bits
#   select_support_mcl<1> m_high_1_select
#   select_support_mcl<0> m_high_0_select
#
# where logm = hi(m)+1 (decremented once if it equals logn = hi(n)+1) and the
# i-th one at position p contributes low bits p & (2**wl - 1) and a one at
# high position (p >> wl) + i.  int_vector<0> self-describes as uint64
# size-in-bits + uint8 width + ceil(bits/64) LE words; bit_vector as uint64
# size-in-bits + words (LSB-first within each word).
#
# The two trailing select-support blocks ARE written (encode_sd_vector
# default): select_support_mcl<t_b,1> frames per sdsl-lite's
# select_support_mcl.hpp serialize()/load() --
#
#   uint64 arg_cnt                     number of pattern bits (1s resp. 0s)
#   [if arg_cnt > 0]
#   int_vector<0> superblock           ceil(arg_cnt/4096) absolute positions
#                                      of each superblock's first argument,
#                                      width logn = hi(ceil64(nbits))+1
#   bit_vector    mini_or_long         EMPTY if no long blocks exist, else
#                                      one flag per superblock
#   per superblock, in order, exactly one of
#     long block:  int_vector<0>(4096, width hi(last_arg_pos)+1) holding every
#                  argument position absolutely (chosen when the block spans
#                  > logn**4 positions)
#     mini block:  int_vector<0>(64, width hi(span)+1) holding the position of
#                  every 64th argument relative to the superblock start
#
# sdsl's load() reads these self-describing frames verbatim (widths come from
# the int_vector headers, never recomputed), so loadability requires only
# structural validity; select_support_mcl_query() below implements the query
# algorithm over the emitted blocks and is differential-tested against
# np.flatnonzero to prove that validity.  Byte-identity with sdsl's *builder*
# output additionally needs sdsl's exact width choices, reproduced here from
# select_support_mcl.hpp init_slow(); unverifiable in this environment (no
# sdsl, no network) -- flagged in docs/PARITY.md.  Reading still tolerates
# absent select blocks (our pre-round-2 files).

def _bits_hi(x: int) -> int:
    """sdsl bits::hi — index of the highest set bit (0 for x == 0)."""
    return x.bit_length() - 1 if x > 0 else 0


def encode_sdsl_int_vector(values: np.ndarray, width: int) -> bytes:
    """int_vector<0>: uint64 size-in-bits, uint8 width, LE 64-bit words with
    value i at bits [i*width, (i+1)*width), LSB-first."""
    v = np.asarray(values, dtype=np.uint64)
    if width < 1 or width > 64:
        raise ValueError(f"width {width} out of range")
    if v.size and width < 64 and int(v.max(initial=0)) >= (1 << width):
        raise OverflowError(f"value does not fit {width} bits")
    bits = v.size * width
    shifts = np.arange(width, dtype=np.uint64)
    bit_mat = ((v[:, None] >> shifts[None, :]) & np.uint64(1)).astype(np.uint8)
    flat = np.zeros(((bits + 63) // 64) * 64, dtype=np.uint8)
    flat[:bits] = bit_mat.reshape(-1)
    data = np.packbits(flat, bitorder="little").tobytes()
    return (np.array([bits], dtype="<u8").tobytes()
            + np.uint8(width).tobytes() + data)


def decode_sdsl_int_vector(raw: bytes, off: int = 0) -> tuple[np.ndarray, int, int]:
    """Returns (values uint64, width, next offset)."""
    bits = int(np.frombuffer(raw[off:off + 8], dtype="<u8")[0])
    width = raw[off + 8]
    if width < 1 or width > 64 or bits % width:
        raise ValueError(f"bad int_vector header: bits={bits} width={width}")
    n_words = (bits + 63) // 64
    body = np.frombuffer(raw[off + 9:off + 9 + 8 * n_words], dtype=np.uint8)
    flat = np.unpackbits(body, bitorder="little")[:bits]
    mat = flat.reshape(-1, width).astype(np.uint64)
    weights = np.uint64(1) << np.arange(width, dtype=np.uint64)
    return (mat * weights).sum(axis=1, dtype=np.uint64), width, off + 9 + 8 * n_words


def encode_sdsl_bit_vector(bits: np.ndarray) -> bytes:
    """bit_vector: uint64 size-in-bits + LE 64-bit words."""
    b = np.asarray(bits, dtype=bool)
    padded = np.zeros(((b.size + 63) // 64) * 64, dtype=bool)
    padded[:b.size] = b
    return (np.array([b.size], dtype="<u8").tobytes()
            + np.packbits(padded, bitorder="little").tobytes())


def decode_sdsl_bit_vector(raw: bytes, off: int = 0) -> tuple[np.ndarray, int]:
    nbits = int(np.frombuffer(raw[off:off + 8], dtype="<u8")[0])
    n_words = (nbits + 63) // 64
    body = np.frombuffer(raw[off + 8:off + 8 + 8 * n_words], dtype=np.uint8)
    return (np.unpackbits(body, bitorder="little")[:nbits].astype(bool),
            off + 8 + 8 * n_words)


_SELECT_SB = 4096  # arguments per superblock (select_support_mcl.hpp)


def _mcl_logn(nbits: int) -> int:
    """select_support_mcl m_logn: hi of nbits rounded up to a 64-bit word."""
    return _bits_hi(((nbits + 63) >> 6) << 6) + 1


def encode_select_support_mcl(bits: np.ndarray, pattern: int = 1) -> bytes:
    """Serialize a select_support_mcl<pattern,1> over a plain bit vector
    (layout per the module comment; construction semantics per sdsl-lite
    select_support_mcl.hpp init_slow)."""
    b = np.asarray(bits, dtype=bool)
    args = np.flatnonzero(b if pattern else ~b).astype(np.uint64)
    head = np.array([args.size], dtype="<u8").tobytes()
    if args.size == 0:
        return head
    logn = _mcl_logn(b.size)
    logn4 = logn ** 4
    sb = (args.size + _SELECT_SB - 1) // _SELECT_SB
    is_long = np.zeros(sb, dtype=bool)
    blocks = []
    for i in range(sb):
        blk = args[i * _SELECT_SB:(i + 1) * _SELECT_SB]
        span = int(blk[-1] - blk[0])
        if span > logn4:
            is_long[i] = True
            vals = np.zeros(_SELECT_SB, dtype=np.uint64)
            vals[:blk.size] = blk  # absolute positions, zero-padded tail
            blocks.append(encode_sdsl_int_vector(vals, _bits_hi(int(blk[-1])) + 1))
        else:
            vals = np.zeros(64, dtype=np.uint64)
            rel = blk[::64] - blk[0]  # every 64th argument, relative
            vals[:rel.size] = rel
            blocks.append(encode_sdsl_int_vector(vals, _bits_hi(span) + 1))
    mini_or_long = is_long if is_long.any() else np.zeros(0, dtype=bool)
    return (head + encode_sdsl_int_vector(args[::_SELECT_SB], logn)
            + encode_sdsl_bit_vector(mini_or_long) + b"".join(blocks))


def decode_select_support_mcl(raw: bytes, off: int = 0) -> tuple[dict, int]:
    """Parse one select_support_mcl frame; returns (structure, next offset)."""
    arg_cnt = int(np.frombuffer(raw[off:off + 8], dtype="<u8")[0])
    off += 8
    if arg_cnt == 0:
        return {"arg_cnt": 0, "superblock": np.empty(0, np.uint64),
                "is_long": np.empty(0, bool), "blocks": []}, off
    superblock, _, off = decode_sdsl_int_vector(raw, off)
    is_long, off = decode_sdsl_bit_vector(raw, off)
    sb = (arg_cnt + _SELECT_SB - 1) // _SELECT_SB
    blocks = []
    for _ in range(sb):
        v, _, off = decode_sdsl_int_vector(raw, off)
        blocks.append(v)
    return {"arg_cnt": arg_cnt, "superblock": superblock,
            "is_long": is_long, "blocks": blocks}, off


def select_support_mcl_query(st: dict, bits: np.ndarray, i: int,
                             pattern: int = 1) -> int:
    """The select_support_mcl::select algorithm over a decoded frame: 1-based
    i-th occurrence of `pattern` in `bits`.  Used to prove emitted structures
    are algorithmically valid (what sdsl's loaded query code would compute)."""
    if not (1 <= i <= st["arg_cnt"]):
        raise ValueError("select index out of range")
    i -= 1
    sb_idx, offset = i >> 12, i & 0xFFF
    if st["is_long"].size and st["is_long"][sb_idx]:
        return int(st["blocks"][sb_idx][offset])
    pos = int(st["superblock"][sb_idx]) + int(st["blocks"][sb_idx][offset >> 6])
    rem = offset & 0x3F
    v = np.asarray(bits, dtype=bool)
    if not pattern:
        v = ~v
    while rem:  # forward word scan in sdsl; linear here (verifier only)
        pos += 1
        rem -= int(v[pos])
    return pos


def encode_sd_vector(positions: np.ndarray, size: int,
                     with_select: bool = True) -> bytes:
    """Elias-Fano encode sorted bit positions over a length-`size` vector
    (sd_vector layout incl. the high-vector select_1/select_0 supports; see
    module comment)."""
    pos = np.asarray(positions, dtype=np.uint64)
    if pos.size and (int(pos.max()) >= size or np.any(np.diff(pos.astype(np.int64)) <= 0)):
        raise ValueError("positions must be strictly increasing and < size")
    m = pos.size
    logm = _bits_hi(m) + 1
    logn = _bits_hi(size) + 1
    if logm == logn:
        logm -= 1
    wl = logn - logm
    low = pos & np.uint64((1 << wl) - 1)
    high = np.zeros(m + (1 << logm), dtype=bool)
    high[(pos >> np.uint64(wl)).astype(np.int64) + np.arange(m)] = True
    core = (np.array([size], dtype="<u8").tobytes() + np.uint8(wl).tobytes()
            + encode_sdsl_int_vector(low, wl) + encode_sdsl_bit_vector(high))
    if with_select:
        core += (encode_select_support_mcl(high, 1)
                 + encode_select_support_mcl(high, 0))
    return core


def decode_sd_vector(raw: bytes, off: int = 0) -> tuple[np.ndarray, int, int]:
    """Returns (positions int64, size, next offset past the EF core)."""
    size = int(np.frombuffer(raw[off:off + 8], dtype="<u8")[0])
    wl = raw[off + 8]
    low, width, off2 = decode_sdsl_int_vector(raw, off + 9)
    if width != wl:
        raise ValueError(f"sd_vector low width {width} != wl {wl}")
    high, off3 = decode_sdsl_bit_vector(raw, off2)
    ones = np.flatnonzero(high)
    positions = ((ones - np.arange(ones.size)).astype(np.int64) << int(wl)) \
        | low.astype(np.int64)
    return positions, size, off3


def skip_select_support_mcl(raw: bytes, off: int) -> int:
    """Best-effort skip of one serialized select_support_mcl block (framing
    per sdsl-lite: uint64 arg_cnt; if nonzero an int_vector<0> superblock
    array, a mini_or_long bit_vector, then one int_vector<0> per superblock).
    Raises ValueError when the frames do not line up."""
    arg_cnt = int(np.frombuffer(raw[off:off + 8], dtype="<u8")[0])
    off += 8
    if arg_cnt == 0:
        return off
    _, _, off = decode_sdsl_int_vector(raw, off)       # superblocks
    _, off = decode_sdsl_bit_vector(raw, off)          # mini_or_long
    sb = (arg_cnt + 4095) >> 12
    for _ in range(sb):
        _, _, off = decode_sdsl_int_vector(raw, off)   # long- or mini-block
    return off


def write_sdsl_sd_vector(path: str | Path, positions: np.ndarray, size: int) -> None:
    """The sparse `.col_runs.sv` variant (include/col_split.hpp:377-382)."""
    Path(path).write_bytes(encode_sd_vector(positions, size))


def read_sdsl_sd_vector(path: str | Path) -> tuple[np.ndarray, int]:
    positions, size, _ = decode_sd_vector(Path(path).read_bytes())
    return positions, size


# .FL_table (build_FL -> col_split handoff): n (8B) + r (8B) + sd_vector
# L_heads + r packed 12-byte FL_rows (char:8 idx:40 interval:32 offset:16
# bits, LSB-first) -- FL_table::serialize, include/ds/FL_table.hpp:303-333.

_FL_ROW_BYTES = 12


def write_fl_table_file(path: str | Path, *, n: int, char: np.ndarray,
                        idx: np.ndarray, dest_interval: np.ndarray,
                        dest_offset: np.ndarray, l_heads: np.ndarray) -> None:
    r = int(np.asarray(char).size)
    rows = np.zeros((r, _FL_ROW_BYTES), dtype=np.uint8)

    def put(field, byte_off, width):
        v = np.asarray(field, dtype=np.uint64)
        if width < 8 and v.size and int(v.max(initial=0)) >= (1 << (8 * width)):
            raise OverflowError(f"field at offset {byte_off} overflows {width}B")
        for b in range(width):
            rows[:, byte_off + b] = ((v >> np.uint64(8 * b)) & np.uint64(0xFF)
                                     ).astype(np.uint8)

    put(char, 0, 1)
    put(idx, 1, 5)            # BWT_BYTES = 5
    put(dest_interval, 6, 4)  # RUN_BYTES = 4
    put(dest_offset, 10, 2)   # LEN_BYTES = 2
    header = np.array([n, r], dtype="<u8").tobytes()
    Path(path).write_bytes(header + encode_sd_vector(l_heads, n) + rows.tobytes())


def read_fl_table_file(path: str | Path) -> dict:
    raw = Path(path).read_bytes()
    n, r = (int(v) for v in np.frombuffer(raw[:16], dtype="<u8"))
    l_heads, sd_size, off = decode_sd_vector(raw, 16)
    if sd_size != n:
        raise ValueError(f"L_heads size {sd_size} != n {n}")
    if len(raw) - off != r * _FL_ROW_BYTES:
        # tolerate sdsl-written files that carry the two select blocks
        off = skip_select_support_mcl(raw, off)
        off = skip_select_support_mcl(raw, off)
    rows = np.frombuffer(raw[off:off + r * _FL_ROW_BYTES],
                         dtype=np.uint8).reshape(r, _FL_ROW_BYTES)

    def get(byte_off, width):
        v = np.zeros(rows.shape[0], dtype=np.uint64)
        for b in range(width):
            v |= rows[:, byte_off + b].astype(np.uint64) << np.uint64(8 * b)
        return v

    return {
        "n": n, "r": r, "l_heads": l_heads,
        "char": get(0, 1).astype(np.uint8),
        "idx": get(1, 5).astype(np.int64),
        "dest_interval": get(6, 4).astype(np.int64),
        "dest_offset": get(10, 2).astype(np.int64),
    }
