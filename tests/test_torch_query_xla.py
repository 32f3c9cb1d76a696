"""Compact engine: the PyTorch port against the JAX package.

Both packages get the same index arrays and the same reads, made from a
seed with numpy; the port runs its plain PyTorch path on the CPU.  Every
compared value is an integer, so every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colbwt_tpu.models.index import ColPmlIndex
from colbwt_tpu.ops import oracle as O
from colbwt_tpu.ops import query_xla as JX
from colbwt_tpu_torch.models import tensors as TT
from colbwt_tpu_torch.models.tensors import index_tensors, to_device
from colbwt_tpu_torch.ops import query_xla as TX
from tests.conftest import random_docs
from tests.test_query_xla import build_index, make_reads

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0x71A4)
    base = bytes(rng.choice(list(b"ACGT"), 220).astype("uint8"))
    docs = random_docs(rng, 3, mutate_from=base)
    tbl, unsplit = build_index(docs)
    split = ColPmlIndex.build(tbl, ff_bound=2)
    reads = make_reads(rng, docs, 24) + [b"NNNNNNN", b"ACGTNACGT", b"A"]
    return tbl, unsplit, split, reads


def test_index_tensors_match_jax(case):
    _, index, _, _ = case
    got = index_tensors(index, CPU)
    want = JX.index_device_arrays(index)
    assert set(got) == set(want)
    for name, arr in want.items():
        g = got[name]
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_array_equal(g, np.asarray(arr), err_msg=name)


@pytest.mark.parametrize("which", ["unsplit", "split", "split-unbounded"])
def test_query_batch_device_matches_jax(case, which):
    """ff_bound 0 on the unsplit index; on ColPmlIndex.build(tbl,
    ff_bound=2) both its recorded bound and the unbounded loop."""
    _, unsplit, split, reads = case
    index = unsplit if which == "unsplit" else split
    ff = index.ff_bound if which == "split" else 0
    assert (ff >= 2) == (which == "split")
    enc, lens = index.encode_patterns(reads, 64)
    wp, wc = JX.query_batch_device(JX.index_device_arrays(index),
                                   jnp.asarray(enc), jnp.asarray(lens),
                                   ff_bound=ff)
    gp, gc = TX.query_batch_device(index_tensors(index, CPU),
                                   to_device(enc, CPU), to_device(lens, CPU),
                                   ff_bound=ff)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


def test_uint8_patterns_equal_int32(case):
    _, index, _, reads = case
    enc, lens = index.encode_patterns(reads, 64)
    tb = index_tensors(index, CPU)
    a = TX.query_batch_device(tb, to_device(enc, CPU), to_device(lens, CPU))
    b = TX.query_batch_device(tb, to_device(enc, CPU, np.uint8),
                              to_device(lens, CPU))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_query_batch_matches_jax_and_oracle(case):
    tbl, _, split, reads = case
    wp, wc = JX.query_batch(split, reads, max_len=64)
    gp, gc = TX.query_batch(split, reads, max_len=64, device=CPU)
    for read, a, b, c, d in zip(reads, gp, wp, gc, wc):
        np.testing.assert_array_equal(a, b, err_msg=repr(read))
        np.testing.assert_array_equal(c, d, err_msg=repr(read))
        ep, ec = O.query_pml_oracle(tbl, read)
        np.testing.assert_array_equal(a, ep)
        np.testing.assert_array_equal(c, ec)


# ---------------------------------------------------------------------------
# K4's tables and its row-and-pair step, modelled in NumPy
# (csrc/query_xla.cu)
# ---------------------------------------------------------------------------

def _wrap(x):
    """int64 values wrapped to int32's range, as int32 sums wrap."""
    return ((np.asarray(x, np.int64) + (1 << 31)) % (1 << 32)) - (1 << 31)


def test_compact_rows_and_pairs_match_fields(case):
    """The run rows: the index's fields, dest_head = JAX's int32
    idx[clip(di)] + doff and the first fast-forward round's length
    length[clip(di)]; the pairs: [succ, pred] of (c, j) at c * r + j; and
    compact_tables' views of them equal JAX's fields."""
    _, index, split, _ = case
    for idx in (index, split):
        tb = index_tensors(idx, CPU)
        rows = TT.compact_rows(tb).numpy()
        pairs = TT.jump_pairs(tb["succ_jump"], tb["pred_jump"]).numpy()
        want = JX.index_device_arrays(idx)
        r = idx.r
        di = jnp.clip(want["dest_interval"], 0, r - 1)
        assert rows.dtype == np.int32 and rows.shape == (r, 8)
        for f, j in TT.ROW_FIELDS.items():
            np.testing.assert_array_equal(rows[:, j], np.asarray(want[f]))
        np.testing.assert_array_equal(
            rows[:, 4], np.asarray(jnp.take(want["idx"], di)
                                   + want["dest_offset"]))
        np.testing.assert_array_equal(rows[:, 6],
                                      np.asarray(jnp.take(want["length"], di)))
        assert pairs.dtype == np.int32 and pairs.shape == ((idx.sigma + 1) * r,
                                                           2)
        np.testing.assert_array_equal(
            pairs[:, 0], np.asarray(want["succ_jump"]).reshape(-1))
        np.testing.assert_array_equal(
            pairs[:, 1], np.asarray(want["pred_jump"]).reshape(-1))
        views = TT.compact_tables(idx, CPU)
        for name in TT.SOA_FIELDS:
            np.testing.assert_array_equal(views[name].numpy(),
                                          np.asarray(want[name]),
                                          err_msg=name)
        np.testing.assert_array_equal(views["rows"].numpy(), rows)
        np.testing.assert_array_equal(views["pairs"].numpy(), pairs)


def test_compact_rows_wrap():
    """dest_head wraps as JAX's int32 sum does; both indexes clip."""
    i32 = torch.int32
    tb = {"idx": torch.tensor([0, 5, INT32_MAX - 3], dtype=i32),
          "dest_interval": torch.tensor([2, 7, -1], dtype=i32),
          "dest_offset": torch.tensor([9, 1, 2], dtype=i32),
          "length": torch.tensor([5, 6, 7], dtype=i32)}
    for f in ("char", "col_id", "threshold"):
        tb[f] = torch.zeros(3, dtype=i32)
    rows = TT.compact_rows(tb).numpy()
    np.testing.assert_array_equal(rows[:, 4],
                                  _wrap([INT32_MAX + 6, INT32_MAX - 2, 2]))
    np.testing.assert_array_equal(rows[:, 6], [7, 7, 5])


INT32_MAX = (1 << 31) - 1


def xla_model(rows, pairs, r, n, patterns, lengths, ff_bound):
    """The kernel's step over `rows` and `pairs`, a read a lane: the row of
    clip(interval) and the pair of (c, interval); on a mismatch the rows of
    clip(succ) and clip(pred), the interval taken one of the three; the
    LF step and the first fast-forward round from the chosen row (its
    folded length), rounds 2.. from the lengths in the rows of the next
    runs.  Returns (pml, cid) (B, M) int32 and how many steps matched, took
    the pred, took the succ, kept the state (no succ and no pred), and how
    many fast-forward rounds past the first ran."""
    rows = rows.astype(np.int64)
    pairs = pairs.astype(np.int64)
    J = pairs.shape[0]
    B, M = patterns.shape
    pml = np.zeros((B, M), np.int64)
    cid = np.zeros((B, M), np.int64)
    count = dict(match=0, pred=0, succ=0, keep=0, rounds=0)
    for b in range(B):
        interval = r - 1
        offset = _wrap(rows[r - 1, 5] - 1)
        pos, mlen = _wrap(n - 1), 0
        for i in range(min(max(int(lengths[b]), 0), M)):
            col = M - 1 - i
            c = int(patterns[b, col])
            iv = min(max(interval, 0), r - 1)
            succ, pred = pairs[min(max(c * r + interval, 0), J - 1)]
            cur = rows[iv]
            match = cur[0] == c
            ch, off = cur, offset
            if match:
                count["match"] += 1
            else:
                has_succ, has_pred = succ < r, pred >= 0
                rs = rows[min(succ, r - 1)] if has_succ else None
                rp = rows[max(pred, 0)] if has_pred else None
                thr = rs[7] if has_succ else n
                if pos < thr and has_pred:
                    ch, off = rp, _wrap(rp[5] - 1)
                    count["pred"] += 1
                elif has_succ:
                    ch, off = rs, 0
                    count["succ"] += 1
                else:
                    count["keep"] += 1
            di, doff = int(ch[2]), _wrap(ch[3] + off)
            new_pos = _wrap(ch[4] + off)
            if ff_bound != 1 and doff >= ch[6]:
                di, doff = _wrap(di + 1), _wrap(doff - ch[6])
                t = 2
                while ff_bound == 0 or t < ff_bound:
                    count["rounds"] += 1
                    ln = rows[min(max(di, 0), r - 1), 5]
                    if doff < ln:
                        break
                    di, doff = _wrap(di + 1), _wrap(doff - ln)
                    t += 1
            mlen = _wrap(mlen + 1) if match else 0
            interval, offset, pos = di, doff, new_pos
            pml[b, col] = mlen
            cid[b, col] = cur[1]
    return pml.astype(np.int32), cid.astype(np.int32), count


@pytest.mark.parametrize("which,ff", [("unsplit", 0), ("split", 0),
                                      ("split", 1), ("split", 2),
                                      ("split", 3)])
def test_xla_model_matches_plain_and_jax(case, which, ff):
    """K4's row-and-pair step equals the plain version and JAX's
    query_batch_device at ff_bound 0-3, with matches, mismatches that take
    the pred, the succ and neither (reads with N on an ACGT index), and
    (at ff_bound 0 and 3) fast-forward rounds past the first."""
    _, unsplit, split, reads = case
    index = unsplit if which == "unsplit" else split
    enc, lens = index.encode_patterns(reads, 64)
    tb = index_tensors(index, CPU)
    rows = TT.compact_rows(tb).numpy()
    pairs = TT.jump_pairs(tb["succ_jump"], tb["pred_jump"]).numpy()
    gp, gc, count = xla_model(rows, pairs, index.r, index.n, enc, lens, ff)
    wp, wc = TX.query_batch_device_ref(tb, to_device(enc, CPU),
                                       to_device(lens, CPU), ff_bound=ff)
    np.testing.assert_array_equal(gp, wp.numpy())
    np.testing.assert_array_equal(gc, wc.numpy())
    jp, jc = JX.query_batch_device(JX.index_device_arrays(index),
                                   jnp.asarray(enc), jnp.asarray(lens),
                                   ff_bound=ff)
    np.testing.assert_array_equal(gp, np.asarray(jp))
    np.testing.assert_array_equal(gc, np.asarray(jc))
    assert all(count[k] > 0 for k in ("match", "pred", "succ", "keep"))
    assert (count["rounds"] > 0) == (ff in (0, 3))  # rounds past the first
